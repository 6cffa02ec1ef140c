"""The normal-draw study's probe kernels (``csrc/draw_probes.cu``): ports
of the JAX package's two test probe kernels, the normal-draw probe
(``tests/test_pallas_kernels.py:399-412``) and the ``_fast_log`` probe
(``:459-468``).  Their plain PyTorch versions are
:func:`_draw_normals_plain` and ``draws.fast_log``.

:func:`draw_normals` runs on the card unless ``device="cpu"`` is passed,
then it runs the plain version; :func:`fast_log` launches the kernel for a
CUDA tensor and runs the plain version for a CPU tensor.  There is no
fallback: a CUDA call launches the kernel or raises.  Each wrapper counts
its launches in ``launches`` (keyed by the draw for :func:`draw_normals`).
"""
from __future__ import annotations

from collections import Counter

import torch

from ..utils.dtypes import resolve_device
from . import _build, draws

ROWS = 8   # coordinates of a column (the JAX probe's ROWS)


def _check_n(n: int) -> int:
    if n < ROWS or n % ROWS:
        raise ValueError(f"n must be a positive multiple of {ROWS}, got {n}")
    return n // ROWS


def _draw_normals_plain(impl: str, seed: int, n: int, device) -> torch.Tensor:
    """The normals of :func:`draw_normals` from ``draws.step_draws``: the
    increment draws of d = 8 coordinates at rung 0 and absolute step 1."""
    return draws.step_draws(draws.seed_key(seed), 1, 1, ROWS, _check_n(n),
                            device, swap=False, draw=impl)[0][0]


def draw_normals(impl: str, seed: int, n: int,
                 device="cuda") -> torch.Tensor:
    """``(8, n/8)`` f32 normals of draw ``impl`` (any of
    ``draws.NORMAL_IMPLS``) from the Philox stream of ``seed``: column
    ``j`` is replica ``j`` at rung 0 and absolute step 1, row ``k``
    coordinate ``k`` of ``draws.py``'s slot layout for d = 8, so
    Box-Muller pairs rows ``k`` and ``k + 4``."""
    if impl not in draws.NORMAL_IMPLS:
        raise ValueError(f"unknown normal draw {impl!r}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _draw_normals_plain(impl, seed, n, dev)
    cols = _check_n(n)
    out = torch.empty((ROWS, cols), dtype=torch.float32, device=dev)
    key = draws.seed_key(seed)
    fn = _build.entry(_build.PROBES, "rwm_pt_draw_normals")
    rc = fn(_build.DRAWS[impl][1], key[0], key[1], cols, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(f"{_build.PROBES}.draw_normals", rc)
    draw_normals.launches[impl] += 1
    return out


draw_normals.launches = Counter()


def fast_log(y: torch.Tensor) -> torch.Tensor:
    """``draws.fast_log`` (the plain version) of every element of the f32
    tensor ``y`` (finite, > 0): the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if not y.is_cuda:
        return draws.fast_log(y)
    _build.check_cuda("fast_log", torch.float32, y=y)
    out = torch.empty_like(y)
    fn = _build.entry(_build.PROBES, "rwm_pt_fast_log")
    rc = fn(y.data_ptr(), out.data_ptr(), y.numel(),
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check_launch(f"{_build.PROBES}.fast_log", rc)
    fast_log.launches["fast_log"] += 1
    return out


fast_log.launches = Counter()
