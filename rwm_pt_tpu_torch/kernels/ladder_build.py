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
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ..ladders.ladders import DeviceLadder
from . import _build

# the kinds the kernel takes: every kind with a direct sampler
LADDER_KINDS = ("mvn_iso", "mvn_full", "scaled_mvn", "three_mixture",
                "rough_carpet", "even_rosenbrock", "hybrid_rosenbrock",
                "hypercube", "iid_gamma", "iid_beta", "neal_funnel")
THREADS = 256           # csrc/ladder_build.cu: kThreads
STAGE_MAX_BYTES = 32 * 1024   # log-density parameters staged in shared memory
TRACE_MAX = 1 << 12     # probes' estimates a build keeps and reads back


def _f32(*parts) -> torch.Tensor:
    return torch.cat([torch.as_tensor(p).detach().to(torch.float32)
                      .reshape(-1).cpu() for p in parts])


def sampler_params(kind: str, target) -> torch.Tensor:
    """The float32 sampler parameters of ``target`` (kind ``kind``) as
    ``csrc/ladder_build.cu::draw_sample`` reads them, on the CPU."""
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
    """Registers, local bytes, max threads a block, blocks an SM (with
    ``n_params`` log-density words staged) and SMs of the library of
    ``kind`` at ``dim``."""
    name = _build.ladder_lib(kind, dim)
    out = (ctypes.c_int * 5)()
    shared = 4 * n_params if 4 * n_params <= STAGE_MAX_BYTES else 0
    _build.check_launch(name, _build.entry(
        name, "rwm_pt_ladder_build_info")(shared, out))
    keys = ("registers", "local_bytes", "max_threads", "blocks_per_sm",
            "sms")
    return dict(zip(keys, list(out)))


def launch_ladder_kernel(target, *, target_swap_acceptance_rate: float =
                         0.234, beta_min: float = 0.01,
                         N_samples_swap_est: int = 3000,
                         tolerance: float = 0.005, initial_pn: float = 0.5,
                         pn_update_power: float = -0.25,
                         max_pn_adjustment_steps: int = 100,
                         pn_clamping_range=(-10.0, 10.0),
                         convergence_failure_tolerance_factor: float = 3.0,
                         seed: int = 0, max_T: int = 24,
                         matmul_precision: str = "float32") -> DeviceLadder:
    """One build on the card: one launch, one read of its result
    (``construct_iterative_ladder_device``'s arguments); the estimates of
    every probe it can make are kept, up to :data:`TRACE_MAX`."""
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
    name = _build.ladder_lib(kind, target.dim)
    fn = _build.entry(name, "rwm_pt_ladder_build")
    params = _build.kernel_target(target)[1].to(dev)
    sparams = sampler_params(kind, target).to(dev)
    n = int(N_samples_swap_est)
    cap = max(1, min(TRACE_MAX, max_T * max_pn_adjustment_steps))
    tiles = torch.empty(-(-n // THREADS), dtype=torch.float64, device=dev)
    ctl = torch.empty(4, dtype=torch.int32, device=dev)
    out = torch.empty(2 + max_T + cap, dtype=torch.float64, device=dev)
    # the pn step nu^pn_update_power of nu = 1 .. max_pn, the plain
    # version's Python arithmetic (no pow on the card)
    steps = torch.tensor([nu ** pn_update_power for nu in
                          range(1, max(1, max_pn_adjustment_steps) + 1)],
                         dtype=torch.float64).to(dev)
    k0, k1 = seed_key(seed)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(params.data_ptr(), params.numel(), sparams.data_ptr(),
                target.dim, n, k0, k1, float(target_swap_acceptance_rate),
                float(beta_min), float(tolerance), float(initial_pn),
                steps.data_ptr(), float(pn_clamping_range[0]),
                float(pn_clamping_range[1]), int(max_pn_adjustment_steps),
                float(convergence_failure_tolerance_factor), int(max_T),
                int(matmul_precision == "bfloat16"), cap, tiles.data_ptr(),
                ctl.data_ptr(), out.data_ptr(), stream)
    _build.check_launch(name, rc)
    launch_ladder_kernel.launches[f"{_build.LADDER}.{kind}"] += 1
    host = out.cpu().tolist()
    T, probes = int(host[0]), int(host[1])
    return DeviceLadder(host[2:2 + T], probes,
                        host[2 + max_T:2 + max_T + min(probes, cap)])


launch_ladder_kernel.launches = Counter()
