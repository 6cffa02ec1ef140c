"""The normal-draw study's probe kernels (``csrc/draw_probes.cu``): ports
of the JAX package's two test probe kernels, the normal-draw probe
(``tests/test_pallas_kernels.py:399-412``) and the ``_fast_log`` probe
(``:459-468``).  Their plain PyTorch versions are
:func:`_draw_normals_plain` and ``draws.fast_log``.

:func:`draw_normals` runs on the card unless ``device="cpu"`` is passed,
then it runs the plain version; :func:`fast_log` launches the kernel for a
CUDA tensor and runs the plain version for a CPU tensor.  There is no
fallback: a CUDA call launches the kernel or raises.  Each wrapper counts
its launches in ``launches`` (keyed by the draw for :func:`draw_normals`)
and writes into ``out=`` where given (checked for shape, type, device and
contiguity), else into one ``torch.empty``.

The launch path does little host work, since the kernels take a few
microseconds: a device argument is resolved once (``resolve_device``, so a
CUDA device without a card still raises), the C entry points are looked up
once a process and held here, and the stream is PyTorch's current one, read
at each call as its raw handle (a call inside ``torch.cuda.stream(s)`` or a
CUDA graph capture launches on that stream).
"""
from __future__ import annotations

from collections import Counter

import torch

from ..utils.dtypes import resolve_device
from . import _build, draws

ROWS = 8   # coordinates of a column (the JAX probe's ROWS)
_CODES = {impl: _build.DRAWS[impl][1] for impl in draws.NORMAL_IMPLS}
_DEVICES: dict = {}   # device argument -> (resolve_device(it), card index)
# the C entry points and the current stream's raw handle, once loaded
_DRAW_NORMALS = _FAST_LOG = _RAW_STREAM = None


def _device(device) -> tuple[torch.device, int]:
    """``resolve_device(device)`` and the index of its card for the stream
    handle (-1: the current card), once for each distinct argument."""
    got = _DEVICES.get(device)
    if got is None:
        dev = resolve_device(device)
        got = _DEVICES[device] = (dev, -1 if dev.index is None else dev.index)
    return got


def _entries():
    """Build and load the probes' library once; hold its entry points and
    ``torch._C._cuda_getCurrentRawStream`` (a card's current stream as a
    handle, without building a ``torch.cuda.Stream``)."""
    global _DRAW_NORMALS, _FAST_LOG, _RAW_STREAM
    _DRAW_NORMALS = _build.entry(_build.PROBES, "rwm_pt_draw_normals")
    _FAST_LOG = _build.entry(_build.PROBES, "rwm_pt_fast_log")
    _RAW_STREAM = torch._C._cuda_getCurrentRawStream


def _check_n(n: int) -> int:
    if n < ROWS or n % ROWS:
        raise ValueError(f"n must be a positive multiple of {ROWS}, got {n}")
    return n // ROWS


def _check_out(name: str, out: torch.Tensor, shape, dev: torch.device):
    """Raise unless ``out`` is a contiguous f32 tensor of ``shape`` on
    ``dev`` (a device without an index takes any card's)."""
    if (out.dtype is not torch.float32 or out.shape != shape
            or out.device.type != dev.type
            or (dev.index is not None and out.device.index != dev.index)
            or not out.is_contiguous()):
        raise ValueError(
            f"{name}: out must be a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {dev}, got {out.dtype} {tuple(out.shape)} "
            f"on {out.device}"
            + ("" if out.is_contiguous() else ", not contiguous"))


def _check_apart(out: torch.Tensor, y: torch.Tensor):
    """Raise if ``out`` overlaps ``y`` other than as the same elements: the
    kernel reads ``y`` through the read-only cache while other threads
    write ``out``, so a shifted view would read logs, not inputs."""
    yp, op = y.data_ptr(), out.data_ptr()
    same = yp == op and y.dtype == out.dtype
    if not same and yp < op + out.nbytes and op < yp + y.nbytes:
        raise ValueError("fast_log: out overlaps y (give y itself or "
                         "memory apart from it)")


def _draw_normals_plain(impl: str, seed: int, n: int, device) -> torch.Tensor:
    """The normals of :func:`draw_normals` from ``draws.step_draws``: the
    increment draws of d = 8 coordinates at rung 0 and absolute step 1."""
    return draws.step_draws(draws.seed_key(seed), 1, 1, ROWS, _check_n(n),
                            device, swap=False, draw=impl)[0][0]


def draw_normals(impl: str, seed: int, n: int, device="cuda",
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``(8, n/8)`` f32 normals of draw ``impl`` (any of
    ``draws.NORMAL_IMPLS``) from the Philox stream of ``seed``: column
    ``j`` is replica ``j`` at rung 0 and absolute step 1, row ``k``
    coordinate ``k`` of ``draws.py``'s slot layout for d = 8, so
    Box-Muller pairs rows ``k`` and ``k + 4``.  Written into ``out``
    (returned) where given."""
    code = _CODES.get(impl)
    if code is None:
        raise ValueError(f"unknown normal draw {impl!r}")
    dev, index = _device(device)
    cols = _check_n(n)
    if out is not None:
        _check_out("draw_normals", out, (ROWS, cols), dev)
    if dev.type == "cpu":
        z = _draw_normals_plain(impl, seed, n, dev)
        return z if out is None else out.copy_(z)
    key0, key1 = draws.seed_key(seed)
    if out is None:
        out = torch.empty(ROWS, cols, dtype=torch.float32, device=dev)
    if _DRAW_NORMALS is None:
        _entries()
    rc = _DRAW_NORMALS(code, key0, key1, cols, out.data_ptr(),
                       _RAW_STREAM(index))
    if rc:
        _build.check_launch(f"{_build.PROBES}.draw_normals", rc)
    draw_normals.launches[impl] += 1
    return out


draw_normals.launches = Counter()


def fast_log(y: torch.Tensor, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """``draws.fast_log`` (the plain version) of every element of the f32
    tensor ``y`` (finite, > 0): the kernel for a CUDA tensor, the plain
    version for a CPU one.  Written into ``out`` (returned) where given:
    ``y`` itself, or memory that ``y`` does not overlap; ``y`` may be a
    contiguous view at any offset, such as ``y[1:]``."""
    if out is not None:
        _check_out("fast_log", out, y.shape, y.device)
        _check_apart(out, y)
    if not y.is_cuda:
        z = draws.fast_log(y)
        return z if out is None else out.copy_(z)
    if y.dtype is not torch.float32 or not y.is_contiguous():
        raise ValueError("fast_log: y must be a contiguous CUDA tensor of "
                         "torch.float32")
    if out is None:
        out = torch.empty_like(y)
    if _FAST_LOG is None:
        _entries()
    rc = _FAST_LOG(y.data_ptr(), out.data_ptr(), y.numel(),
                   _RAW_STREAM(y.get_device()))
    if rc:
        _build.check_launch(f"{_build.PROBES}.fast_log", rc)
    fast_log.launches["fast_log"] += 1
    return out


fast_log.launches = Counter()
