"""Inverse-temperature (beta) ladders (port of
``rwm_pt_tpu.ladders.ladders``): the geometric ladder, the harness's
default, and the iterative stochastic-approximation construction that
targets a swap acceptance rate between adjacent rungs,
rho_{n+1} = rho_n + n^p (a_hat - a*), beta* = beta / (1 + e^rho).

Two builders, as in the JAX package, on one probe stream:

* :func:`construct_iterative_ladder`, the host loop: each probe's
  Monte-Carlo swap estimate (:func:`_estimate_swap_prob`) runs on the
  target's device and is read back before the next decision;
* :func:`construct_iterative_ladder_device`, JAX's one-program builder
  with its ``max_T`` cap: on the card one launch of the CUDA kernel
  ``csrc/ladder_build.cu`` runs the whole search (draws, log-densities,
  the reduction and the decisions) and the host reads the ladder once; on
  the CPU its plain version :func:`_construct_iterative_ladder_device_plain`
  runs the same loop as the host builder over the same probe function.

Probe ``i`` (counted from 1 over a build) draws its samples from Philox
words of ``seed_key(seed)`` with the ladder's counters
(``kernels/draws.py``: ``ladder_words``, ``ProbeStream``) through the
target's ``stream_sample``, so the two builders, and the kernel, draw the
same samples: for one seed they land the same ladder.  A probe's swap
estimate is the mean over its samples of min(1, exp((beta - beta*)(lp* -
lp))), each term in float32, summed in float64 over the kernel's
partition (:func:`partition_sum`).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from ..kernels.draws import ProbeStream, seed_key
from ..targets.base import TargetMixin

TILE = 256     # samples a tile of the probe sum (csrc/ladder_build.cu)


def construct_geometric_ladder(beta_0: float = 1.0, beta_min: float = 1e-2,
                               c: float = 0.5) -> List[float]:
    """Geometric ladder: multiply by ``c`` until ``beta_min``, then append
    it (the reference PT algorithm's fallback ladder)."""
    ladder = []
    curr = beta_0
    while curr > beta_min:
        ladder.append(curr)
        curr = curr * c
    ladder.append(beta_min)
    return ladder


class ProbeKey(NamedTuple):
    """The stream of one probe: the seed's Philox key words, the probe's
    number (from 1) and the precision of the target's matmul operands."""
    key: tuple
    probe: int
    matmul_precision: str = "float32"


def _tree(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two wide) as a block's shared-
    memory tree does: element t += element t + w/2 for t < w/2, w halving
    down to 1."""
    w = a.shape[-1]
    while w > 1:
        w //= 2
        a = a[..., :w] + a[..., w:2 * w]
    return a[..., 0]


def partition_sum(v: torch.Tensor) -> torch.Tensor:
    """float64 sum of ``v`` ``(n,)`` over csrc/ladder_build.cu's
    partition: tiles of :data:`TILE` samples (zeros past n), each summed by
    :func:`_tree`; tile ``r TILE + t`` added in order of r into slot t;
    the :data:`TILE` slots summed by :func:`_tree`.  Every add is the
    kernel's, so a kernel and its plain version differ only by their
    terms."""
    v = v.to(torch.float64)
    n_tiles = -(-v.numel() // TILE)
    v = torch.nn.functional.pad(v, (0, n_tiles * TILE - v.numel()))
    tiles = _tree(v.reshape(n_tiles, TILE))
    rows = -(-n_tiles // TILE)
    tiles = torch.nn.functional.pad(tiles, (0, rows * TILE - n_tiles))
    acc = torch.zeros(TILE, dtype=torch.float64, device=v.device)
    for r in tiles.reshape(rows, TILE):
        acc = acc + r
    return _tree(acc)


def _log_density(target, x, matmul_precision):
    at = getattr(target, "log_density_at", None)
    return (at(x, matmul_precision) if at is not None
            else target.log_density(x))


def _estimate_swap_prob(target, key: ProbeKey, beta_curr, beta_star,
                        n_samples: int) -> float:
    """a_hat = E[min(1, exp((beta_curr - beta_star)(logpi(x*) -
    logpi(x))))] with x* drawn tempered at ``beta_star`` (side 0 of probe
    ``key``) and x at ``beta_curr`` (side 1), float32 0-d tensors,
    ``n_samples`` each; a NaN term stays NaN."""
    dev = target.device
    bc, bs = beta_curr.to(dev), beta_star.to(dev)
    xs = target.stream_sample(ProbeStream(key.key, key.probe, 0, n_samples,
                                          dev), n_samples, bs,
                              key.matmul_precision)
    xc = target.stream_sample(ProbeStream(key.key, key.probe, 1, n_samples,
                                          dev), n_samples, bc,
                              key.matmul_precision)
    log_r = (bc - bs) * (_log_density(target, xs, key.matmul_precision)
                         - _log_density(target, xc, key.matmul_precision))
    v = torch.exp(torch.clamp_max(log_r, 0.0))
    return float(partition_sum(v)) / n_samples


def _check_sampler(target) -> None:
    """Raise, as JAX does, for a target without a direct sampler (and so
    without its stream form, ``stream_sample``), before any draw."""
    impl = getattr(type(target), "stream_sample", None)
    if impl is None or impl is TargetMixin.stream_sample:
        raise NotImplementedError(
            "The target distribution must implement 'direct_sample(n, beta, "
            "generator)' (and its ladder-stream form 'stream_sample') for "
            "iterative temperature ladder construction.")


def _f32(b: float) -> torch.Tensor:
    return torch.tensor(b, dtype=torch.float32)


class DeviceLadder(NamedTuple):
    """A build: the ladder, its probes' count and each probe's swap
    estimate."""
    betas: List[float]
    probes: int
    a_hats: List[float]


def _clip(pn: float, lo: float, hi: float) -> float:
    """``np.clip``'s rule, min(max(pn, lo), hi), NaN passing through (the
    kernel's ``clip``)."""
    pn = lo if pn < lo else pn
    return hi if pn > hi else pn


def _search(target, *, target_swap_acceptance_rate: float = 0.234,
            beta_min: float = 0.01, N_samples_swap_est: int = 3000,
            tolerance: float = 0.005, initial_pn: float = 0.5,
            pn_update_power: float = -0.25,
            max_pn_adjustment_steps: int = 100,
            pn_clamping_range=(-10.0, 10.0),
            convergence_failure_tolerance_factor: float = 3.0, seed: int = 0,
            max_T: int | None = None, matmul_precision: str = "float32",
            verbose: bool = False) -> DeviceLadder:
    """The iterative search, both builders' loop and the plain version of
    the ladder kernel (its thread 0 runs the same recurrence in float64).
    Per rung, probe beta* = beta / (1 + e^clip(pn)) until the estimated
    swap rate is within ``tolerance`` of the target (then take beta*),
    beta* falls below ``beta_min`` (stop before its probe) or
    ``max_pn_adjustment_steps`` probes are spent; only such an exhausted
    rung is still taken, within ``tolerance *
    convergence_failure_tolerance_factor``.  Rungs are searched while
    beta > beta_min + 1e-6 and, under a ``max_T`` cap (JAX's
    ``_device_ladder``; None: none), while the ladder has fewer than
    ``max_T - 1`` rungs; a last beta above beta_min + 1e-5 gets beta_min
    appended.  Probes number from 1 over the build.  A target of another
    dtype is estimated as its float32 copy, the kernel's arithmetic."""
    _check_sampler(target)
    if getattr(target, "dtype", torch.float32) != torch.float32:
        target = target.to(dtype=torch.float32)
    rate = target_swap_acceptance_rate
    lo, hi = pn_clamping_range
    key = seed_key(seed)
    betas = [1.0]
    beta_curr, probe, a_hats = 1.0, 0, []
    while beta_curr > beta_min + 1e-6 and (max_T is None
                                           or len(betas) < max_T - 1):
        pn, nu, it = initial_pn, 1, 0
        found = stop = False
        bstar, ahat = -1.0, -1.0
        while not found and not stop and it < max_pn_adjustment_steps:
            beta_star = beta_curr / (1.0 + math.exp(_clip(pn, lo, hi)))
            bstar = beta_star
            if beta_star < beta_min:
                stop, ahat = True, -1.0
                break
            probe += 1
            a = float(_estimate_swap_prob(
                target, ProbeKey(key, probe, matmul_precision),
                _f32(beta_curr), _f32(beta_star), N_samples_swap_est))
            a_hats.append(a)
            ahat = a
            if verbose:
                print(f"  probe beta*={beta_star:.6f} a_hat={a:.4f}")
            found = abs(a - rate) <= tolerance
            if not found:
                pn = pn + nu ** pn_update_power * (a - rate)
            nu, it = nu + 1, it + 1
        rescue = (not found and not stop and it >= max_pn_adjustment_steps
                  and bstar >= beta_min
                  and abs(ahat - rate) <= (
                      tolerance * convergence_failure_tolerance_factor))
        if not (found or rescue):
            break
        if rescue and verbose:
            print(f"  accepting beta*={bstar:.6f} at wider tol")
        betas.append(bstar)
        beta_curr = bstar
    if betas[-1] > beta_min + 1e-5:
        betas.append(beta_min)
    return DeviceLadder(betas, probe, a_hats)


def construct_iterative_ladder(target, *,
                               target_swap_acceptance_rate: float = 0.234,
                               beta_min: float = 0.01,
                               N_samples_swap_est: int = 3000,
                               tolerance: float = 0.005,
                               initial_pn: float = 0.5,
                               pn_update_power: float = -0.25,
                               max_pn_adjustment_steps: int = 100,
                               pn_clamping_range=(-10.0, 10.0),
                               convergence_failure_tolerance_factor:
                               float = 3.0,
                               seed: int = 0,
                               verbose: bool = False) -> List[float]:
    """Iterative ladder construction, the JAX host loop step for step
    (:func:`_search` with no cap): one read of the device a probe, the
    recurrence in float64 on the host.  The target must have a direct
    sampler.  Probe ``i`` (counted from 1 over the whole build) draws from
    the ladder stream of ``seed_key(seed)`` (module docstring)."""
    return _search(
        target, target_swap_acceptance_rate=target_swap_acceptance_rate,
        beta_min=beta_min, N_samples_swap_est=N_samples_swap_est,
        tolerance=tolerance, initial_pn=initial_pn,
        pn_update_power=pn_update_power,
        max_pn_adjustment_steps=max_pn_adjustment_steps,
        pn_clamping_range=pn_clamping_range,
        convergence_failure_tolerance_factor=(
            convergence_failure_tolerance_factor),
        seed=seed, verbose=verbose).betas


def _construct_iterative_ladder_device_plain(target, *, max_T: int = 24,
                                             **kw) -> DeviceLadder:
    """The plain version of the ladder kernel: JAX's ``_device_ladder``
    (``rwm_pt_tpu/ladders/ladders.py:148-244``), :func:`_search` under
    its ``max_T`` cap, with each probe's swap estimate."""
    return _search(target, max_T=max_T, **kw)


def construct_iterative_ladder_device(target, *,
                                      target_swap_acceptance_rate: float =
                                      0.234,
                                      beta_min: float = 0.01,
                                      N_samples_swap_est: int = 3000,
                                      tolerance: float = 0.005,
                                      initial_pn: float = 0.5,
                                      max_pn_adjustment_steps: int = 100,
                                      convergence_failure_tolerance_factor:
                                      float = 3.0,
                                      seed: int = 0,
                                      max_T: int = 24,
                                      matmul_precision: str = "float32",
                                      pn_update_power: float = -0.25,
                                      pn_clamping_range=(-10.0, 10.0),
                                      ) -> List[float]:
    """The whole iterative search as one program (JAX's signature,
    ``rwm_pt_tpu/ladders/ladders.py:247-259``, and the host builder's pn
    exponent and clamp): on a target on the card, one launch of the
    ladder kernel (``kernels/ladder_build.py``) and one read of its
    result; on the CPU the plain version.  The same ladder as
    :func:`construct_iterative_ladder` for one seed, under JAX's ``max_T``
    cap (the ladder holds at most ``max_T`` rungs, beta_min included).
    ``matmul_precision="bfloat16"`` rounds the operands of the products
    JAX computes as matmuls (the MVN's ``z @ scale.T``, the full MVN's
    ``cov_inv @ x``) to bfloat16, accumulating in float32.  FullRosenbrock
    and SuperFunnel have no direct sampler and raise."""
    _check_sampler(target)
    kw = dict(target_swap_acceptance_rate=target_swap_acceptance_rate,
              beta_min=beta_min, N_samples_swap_est=N_samples_swap_est,
              tolerance=tolerance, initial_pn=initial_pn,
              pn_update_power=pn_update_power,
              max_pn_adjustment_steps=max_pn_adjustment_steps,
              pn_clamping_range=pn_clamping_range,
              convergence_failure_tolerance_factor=(
                  convergence_failure_tolerance_factor),
              seed=seed, max_T=max_T, matmul_precision=matmul_precision)
    if target.device.type == "cuda":
        from ..kernels.ladder_build import launch_ladder_kernel
        return launch_ladder_kernel(target, **kw).betas
    return _construct_iterative_ladder_device_plain(target, **kw).betas


# the rungs a ladder may take when its sampler has no limit of its own
# (the eager engines): far above any real target's ladder
EAGER_MAX_RUNGS = 1023


def check_room(betas: List[float], max_rungs: int,
               beta_min: float = 0.01, layout: str = "") -> List[float]:
    """``betas``, built by :func:`construct_iterative_ladder_device` with
    ``max_T = max_rungs + 1`` for a run that takes at most ``max_rungs``
    rungs (``experiment_pt``, ``MCMCSimulation``): where the cap did not
    stop the search the host loop's uncapped ladder, and returned; where
    it did (the search stood above beta_min + 1e-6 with ``max_rungs``
    rungs), the ladder needs more rungs than the run takes and
    ``NotImplementedError`` is raised, naming ``layout``, what sets the
    run's rungs (``kernels/_build.py::rungs_fit``)."""
    if len(betas) >= max_rungs and betas[max_rungs - 1] > beta_min + 1e-6:
        raise NotImplementedError(
            f"the iterative ladder needs more than {max_rungs} rungs, the "
            f"most this run takes" + (f" ({layout})" if layout else "")
            + f" (its search stood at beta {betas[max_rungs - 1]:.6g} with "
            f"{max_rungs} rungs); pass a beta_ladder or ask for a lower "
            f"swap rate")
    return betas
