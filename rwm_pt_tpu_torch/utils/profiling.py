"""Timing, tracing and memory of device work (port of
``rwm_pt_tpu.utils.profiling``), rebuilt on CUDA.

:class:`DeviceTimer` times a call with CUDA events around it on the card
(the device's own time, ``elapsed``) and the host's wall time beside it
(``wall``), after :func:`force` has waited for the card; on the CPU both
are the wall time.  :func:`force` waits for the card(s) holding the
tensors of its argument (``torch.cuda.synchronize``).
:func:`profile_trace` records a ``torch.profiler`` trace of the CPU and,
on a card, CUDA activity and writes it as a Chrome trace.
:func:`memory_stats` reads ``torch.cuda.memory_stats`` and
``torch.cuda.mem_get_info`` under JAX's keys (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``) for every card; it is empty
without one, as JAX's is on backends without statistics.
:func:`throughput_forensics` times equal chunks of work, each given its own
seed, to find a rate that degrades or memory that leaks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch


def _tensors(tree):
    """The tensors in a result: a tensor, a sequence or mapping of them,
    a NamedTuple or a dataclass, searched recursively."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def force(tree):
    """Wait until the card(s) holding ``tree``'s tensors have finished
    their work; returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


class DeviceTimer:
    """Time of a call: ``elapsed`` in seconds between CUDA events recorded
    around it on the current card's stream (the wall time without a card),
    ``wall`` the host's seconds until :func:`force` returned."""

    def __init__(self):
        self.elapsed = None
        self.wall = None

    def run(self, fn: Callable, *args, **kwargs):
        cuda = torch.cuda.is_available()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if cuda:
            end.record()
            torch.cuda.synchronize()
        force(out)
        self.wall = time.perf_counter() - t0
        self.elapsed = (start.elapsed_time(end) / 1e3 if cuda
                        else self.wall)
        return out


@contextlib.contextmanager
def profile_trace(log_dir: str = "profile_trace"):
    """Record a ``torch.profiler`` trace of the block (CUDA activity too
    on a card) and write it to ``log_dir/trace.json`` (Chrome trace format,
    for Perfetto or ``chrome://tracing``); yields the profiler, whose
    ``key_averages()`` sum the time by operation and kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def memory_stats() -> dict:
    """Per-card memory statistics in bytes, under JAX's keys: the caching
    allocator's ``bytes_in_use`` and ``peak_bytes_in_use``
    (``torch.cuda.memory_stats``) and the card's ``bytes_limit``
    (``torch.cuda.mem_get_info``); empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}
    return out


def throughput_forensics(run_fn: Callable[[int], object], seed: int = 0,
                         num_chunks: int = 5, verbose: bool = True) -> dict:
    """Time ``num_chunks`` equal chunks of device work, ``run_fn(seed + i)``
    for chunk i (a warm-up call with ``seed`` first, not timed), and report
    the chunks' times, the last over the first (about 1 when healthy) and
    the memory before and after."""
    mem_before = memory_stats()
    timer = DeviceTimer()
    timer.run(run_fn, seed)
    times = []
    for i in range(num_chunks):
        timer.run(run_fn, seed + i + 1)
        times.append(timer.elapsed)
        if verbose:
            print(f"  chunk {i + 1}/{num_chunks}: {timer.elapsed:.3f}s")
    mem_after = memory_stats()
    degradation = times[-1] / times[0] if times[0] > 0 else float("nan")
    report = {
        "chunk_times": times,
        "rate_degradation": degradation,
        "memory_before": mem_before,
        "memory_after": mem_after,
    }
    if verbose:
        print(f"  rate degradation (last/first): {degradation:.3f}")
    return report
