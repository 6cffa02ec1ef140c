"""The one-launch iterative ladder builder (``csrc/ladder_build.cu``), the
card's counterpart of the JAX package's one-program builder
(``rwm_pt_tpu/ladders/ladders.py::_device_ladder``).

:func:`launch_ladder_kernel` runs the whole search of
``ladders.construct_iterative_ladder_device`` for a target on the card as
one cooperative launch of the library ``ladder_build.<kind>.d<D>``
(``_build.ladder_lib``) and reads its result back once; its plain version
is ``ladders._construct_iterative_ladder_device_plain``, which runs on the
target's device, whatever it is.  A CPU target raises here: the CPU path
is the plain version's, chosen by the caller.  The kernel takes the 11
kinds with a direct sampler; a target of another kind raises
``NotImplementedError`` before any launch.  Each launch adds one to
``launches`` under ``ladder_build.<kind>``.

A build's host work is one allocation (the result and the kernel's
workspaces, :func:`_workspace`; the full MVN above the 16 bucket a second,
its tables, :func:`full_words`), the launch and one read of the result:
the target's parameter words and the pn-step table reach the card once and
are kept (:func:`_words`, :func:`_pn_steps`).  :func:`probe_split`
launches the library's measuring build instead and reads where a probe's
time goes.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from ..ladders.ladders import DeviceLadder
from . import _build

# the kinds the kernel takes: every kind with a direct sampler
LADDER_KINDS = ("mvn_iso", "mvn_full", "scaled_mvn", "three_mixture",
                "rough_carpet", "even_rosenbrock", "hybrid_rosenbrock",
                "hypercube", "iid_gamma", "iid_beta", "neal_funnel")
TILE = 256              # csrc/ladder_build.cu: kTile, a tile's samples
UNITS = 16              # kUnits: warp-units a tile, a partial sum each
SUMS_A_TILE = UNITS + 3  # doubles a tile: its two sums, partials, count
EVERY_TILES = 16        # kEveryTiles: up to it every block sums the slots
CTL_WORDS = 32          # the ctl workspace, in doubles (kStampOffset bytes)
STAGE_MAX_BYTES = 32 * 1024   # log-density parameters staged in shared memory
TRACE_MAX = 1 << 12     # probes' estimates a build keeps and reads back
# the parts of a probe between its stamps (ladder_lib(..., stamps=True)):
# to the last block's arrival; up to EVERY_TILES tiles to the latest
# block's wait for the arrivals over, then to its slots summed; above, to
# the last block's sum published, then to the latest block holding it;
# to the latest block's search run
SPLIT = ("work", "barrier", "reduce", "next")
SPLIT_PUBLISHED = ("work", "reduce", "barrier", "next")


def _f32(*parts) -> torch.Tensor:
    return torch.cat([torch.as_tensor(p).detach().to(torch.float32)
                      .reshape(-1).cpu() for p in parts])


def sampler_params(kind: str, target) -> torch.Tensor:
    """The float32 sampler parameters of ``target`` (kind ``kind``) as
    ``csrc/ladder_build.cu::side_lp`` reads them, on the CPU."""
    t, d = target, target.dim
    if kind == "mvn_iso":
        return _f32(t.mean)
    if kind == "mvn_full":
        return _f32(t.mean, t.chol)
    if kind == "scaled_mvn":
        return _f32(t.scaling_factors)
    if kind in ("three_mixture", "rough_carpet"):
        from ..targets.multimodal import cum_weights
        cw = cum_weights(t.weights, "cpu")[:2]
        if kind == "three_mixture":
            return _f32(cw, t.scaling_factors, t.means)
        return _f32(cw, t.modes, t.scaling_factors)
    if kind == "even_rosenbrock":
        return _f32(t.a_coeff, t.b_coeff, t.mu[0::2])
    if kind == "hybrid_rosenbrock":
        return _f32(t.a_coeff, t.b_coeff, t.mu, float(t.n1))
    if kind == "hypercube":
        return _f32(t.left, t.right)
    if kind == "iid_gamma":
        return _f32(t.shape, t.scale)
    if kind == "iid_beta":
        return _f32(t.alpha, t.beta)
    if kind == "neal_funnel":
        return _f32(t.mu_v, t.sigma_v_sq, t.mu_z)
    raise NotImplementedError(
        f"the ladder kernel takes the targets with a direct sampler "
        f"({', '.join(LADDER_KINDS)}); kind {kind!r} has none")


def ladder_kind(target) -> str:
    """The ladder kernel's kind of ``target``; a target of no kind with a
    direct sampler raises ``NotImplementedError``."""
    kind = _build.target_kind(target)
    if kind not in LADDER_KINDS:
        raise NotImplementedError(
            f"the ladder kernel takes the registry's targets with a direct "
            f"sampler ({', '.join(LADDER_KINDS)}); "
            f"{type(target).__name__!r} is not one of them")
    return kind


def info(kind: str, dim: int, n_params: int = 0) -> dict:
    """Registers, local bytes, max threads a block, blocks an SM, SMs and
    the dynamic shared bytes a block of a launch of the library of ``kind``
    at ``dim`` with ``n_params`` log-density words (staged where they take
    at most :data:`STAGE_MAX_BYTES`), as the launcher counts them."""
    name = _build.ladder_lib(kind, dim)
    out = (ctypes.c_int * 6)()
    _build.check_launch(name, _build.entry(
        name, "rwm_pt_ladder_build_info")(n_params, dim, out))
    keys = ("registers", "local_bytes", "max_threads", "blocks_per_sm",
            "sms", "shared_bytes")
    return dict(zip(keys, list(out)))


def full_warp(kind: str, dim: int) -> bool:
    """Whether the library of ``kind`` at ``dim`` runs the full MVN's warp
    form (``csrc/ladder_build.cu::kFullWarp``: above the 16 bucket), which
    takes the :func:`full_words` workspace."""
    return kind == "mvn_full" and dim > 16


def full_words(dim: int, n: int) -> int:
    """Floats of the full MVN's warp-form workspace: each side's table of
    S = L / sqrt(beta) and cov_inv's transpose (d^2 each), and the sides'
    lps (N each)."""
    return 3 * dim * dim + 2 * n


def _words(target, kind: str):
    """The log-density's and the sampler's float32 words of ``target`` on
    its device, made (with their copies to the card) once a target."""
    def make():
        dev = target.device
        return (_build.kernel_target(target)[1].to(dev),
                sampler_params(kind, target).to(dev))
    return _build.per_target(target, "ladder_words", make)


@functools.lru_cache(maxsize=64)
def _pn_steps(power: float, max_pn: int, dev: torch.device) -> torch.Tensor:
    """The pn step nu^power of nu = 1 .. max_pn on ``dev``: the plain
    version's Python arithmetic (no pow on the card)."""
    return torch.tensor([nu ** power for nu in range(1, max(1, max_pn) + 1)],
                        dtype=torch.float64).to(dev)


def _workspace(n: int, max_T: int, cap: int, dev: torch.device,
               stamps: int = 0):
    """One float64 allocation: the result (2 + max_T + cap words), the
    tiles' sums, partials and counts and the ctl words (with ``stamps``
    more, zeroed, for a measuring build's stamps)."""
    n_out = 2 + max_T + cap
    n_sums = -(-n // TILE) * SUMS_A_TILE
    buf = torch.empty(n_out + n_sums + CTL_WORDS + stamps,
                      dtype=torch.float64, device=dev)
    ctl = buf[n_out + n_sums:]
    if stamps:
        ctl[CTL_WORDS:].zero_()
    return buf[:n_out], buf[n_out:n_out + n_sums], ctl


def launch_ladder_kernel(target, **kw) -> DeviceLadder:
    """One build on the card: one launch, one read of its result
    (``construct_iterative_ladder_device``'s arguments, :func:`_launch`);
    the estimates of every probe it can make are kept, up to
    :data:`TRACE_MAX`."""
    ladder, _ = _launch(target, False, **kw)
    launch_ladder_kernel.launches[
        f"{_build.LADDER}.{ladder_kind(target)}"] += 1
    return ladder


def probe_split(target, **kw) -> dict:
    """One build by the library's measuring build (``_build.ladder_lib(...,
    stamps=True)``) with :func:`launch_ladder_kernel`'s arguments: the mean
    µs a probe of each part of :data:`SPLIT`, over the probes it stamps (up
    to :data:`TRACE_MAX`), in their order: :data:`SPLIT` up to
    :data:`EVERY_TILES` tiles a probe, :data:`SPLIT_PUBLISHED` above.  Not
    a launch of the ladder kernel: it counts nothing."""
    ladder, words = _launch(target, True, **kw)
    n_tiles = -(-int(kw.get("N_samples_swap_est", 3000)) // TILE)
    names = SPLIT if n_tiles <= EVERY_TILES else SPLIT_PUBLISHED
    parts = [[] for _ in names]
    prev = words[0]
    for i in range(min(ladder.probes, (len(words) - 1) // 4)):
        marks = [prev] + words[1 + 4 * i:5 + 4 * i]
        for j in range(len(names)):
            parts[j].append((marks[j + 1] - marks[j]) / 1e3)
        prev = marks[-1]
    return {k: sum(v) / max(1, len(v)) for k, v in zip(names, parts)}


def _launch(target, stamps: bool, *, target_swap_acceptance_rate: float =
            0.234, beta_min: float = 0.01, N_samples_swap_est: int = 3000,
            tolerance: float = 0.005, initial_pn: float = 0.5,
            pn_update_power: float = -0.25,
            max_pn_adjustment_steps: int = 100,
            pn_clamping_range=(-10.0, 10.0),
            convergence_failure_tolerance_factor: float = 3.0,
            seed: int = 0, max_T: int = 24,
            matmul_precision: str = "float32"):
    """One launch of the library of ``target`` (its measuring build where
    ``stamps``) and one read of its result: (the ladder, the stamps as
    integers: the first probe's start, then 4 a probe, in ns; [] unless
    ``stamps``)."""
    kind = ladder_kind(target)
    dev = target.device
    if dev.type != "cuda":
        raise ValueError("launch_ladder_kernel takes a target on the card; "
                         "the plain version runs elsewhere")
    if matmul_precision not in ("float32", "bfloat16"):
        raise ValueError(f"matmul_precision must be 'float32' or "
                         f"'bfloat16', not {matmul_precision!r}")
    if max_T < 2 or N_samples_swap_est < 1:
        raise ValueError("max_T must be at least 2 and N_samples_swap_est "
                         "at least 1")
    from .draws import seed_key
    name = _build.ladder_lib(kind, target.dim, stamps)
    fn = _build.entry(name, "rwm_pt_ladder_build")
    params, sparams = _words(target, kind)
    n = int(N_samples_swap_est)
    cap = max(1, min(TRACE_MAX, max_T * max_pn_adjustment_steps))
    out, sums, ctl = _workspace(n, max_T, cap, dev,
                                1 + 4 * cap if stamps else 0)
    full = (torch.empty(full_words(target.dim, n), dtype=torch.float32,
                        device=dev) if full_warp(kind, target.dim) else None)
    steps = _pn_steps(float(pn_update_power), int(max_pn_adjustment_steps),
                      dev)
    k0, k1 = seed_key(seed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(params.data_ptr(), params.numel(), sparams.data_ptr(),
                target.dim, n, k0, k1, float(target_swap_acceptance_rate),
                float(beta_min), float(tolerance), float(initial_pn),
                steps.data_ptr(), float(pn_clamping_range[0]),
                float(pn_clamping_range[1]), int(max_pn_adjustment_steps),
                float(convergence_failure_tolerance_factor), int(max_T),
                int(matmul_precision == "bfloat16"), cap, sums.data_ptr(),
                ctl.data_ptr(), None if full is None else full.data_ptr(),
                out.data_ptr(), stream)
    _build.check_launch(name, rc)
    host = out.cpu()   # one read; only the words in use become floats
    T, probes = int(host[0]), int(host[1])
    words = (ctl[CTL_WORDS:].view(torch.int64).cpu().tolist() if stamps
             else [])
    return DeviceLadder(host[2:2 + T].tolist(), probes,
                        host[2 + max_T:2 + max_T + min(probes, cap)]
                        .tolist()), words


launch_ladder_kernel.launches = Counter()
