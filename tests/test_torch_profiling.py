"""The port's profiling utilities (``rwm_pt_tpu_torch.utils.profiling``)
on the CPU, as ``tests/test_resume_and_utils.py`` holds JAX's: the timer,
the memory statistics (empty without a card, as JAX's are on backends
without them), the chunked forensics and the trace."""
import json
import os

import numpy as np
import torch

from rwm_pt_tpu_torch.kernels import run_rwm
from rwm_pt_tpu_torch.kernels.rwm import RWMResult
from rwm_pt_tpu_torch.proposals import NormalProposal
from rwm_pt_tpu_torch.targets import MultivariateNormal
from rwm_pt_tpu_torch.utils import profiling
from rwm_pt_tpu_torch.utils.profiling import (DeviceTimer, force,
                                              memory_stats, profile_trace,
                                              throughput_forensics)

torch.set_num_threads(1)
CPU = "cpu"


def test_device_timer_and_memory_stats():
    timer = DeviceTimer()
    out = timer.run(lambda: torch.sum(torch.ones((100, 100))))
    assert timer.elapsed > 0 and timer.wall >= timer.elapsed
    assert float(out) == 10000.0
    stats = memory_stats()
    assert stats == {}          # no card here


def test_force_finds_tensors_in_results():
    tgt = MultivariateNormal.create(2, device=CPU)
    prop = NormalProposal.create(2, 1.0, device=CPU)
    res = run_rwm(tgt, prop, 0, num_chains=4, num_iterations=3, device=CPU)
    assert force(res) is res
    found = list(profiling._tensors(res))
    assert isinstance(res, RWMResult) and len(found) >= 6
    assert any(t is res.state.x for t in found)


def test_throughput_forensics():
    tgt = MultivariateNormal.create(3, device=CPU)
    prop = NormalProposal.create(3, 1.0, device=CPU)

    def chunk(seed):
        return run_rwm(tgt, prop, seed, num_chains=16, num_iterations=200,
                       burn_in=0, device=CPU)

    report = throughput_forensics(chunk, 0, num_chunks=3, verbose=False)
    assert len(report["chunk_times"]) == 3
    assert np.isfinite(report["rate_degradation"])
    assert report["rate_degradation"] < 10.0
    assert report["memory_before"] == report["memory_after"] == {}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "tr")) as prof:
        torch.sum(torch.ones(64, 64) @ torch.ones(64, 64))
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) or
               "mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
    assert os.path.getsize(path) > 0
