"""Inverse-temperature (beta) ladders (port of
``rwm_pt_tpu.ladders.ladders``): the geometric ladder, the harness's
default, and the iterative stochastic-approximation construction that
targets a swap acceptance rate between adjacent rungs,
rho_{n+1} = rho_n + n^p (a_hat - a*), beta* = beta / (1 + e^rho).

The outer search is data-dependent and stays on the host, as in the JAX
package; each probe's Monte-Carlo swap estimate runs on the target's
device from its own ``torch.Generator``, seeded by (seed, probe).

Not ported yet (ROADMAP Queue A item 10): the one-program
``construct_iterative_ladder_device``.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..kernels.rwm import step_generator

_LADDER_STREAM = 3     # step_generator stream of the ladder's probes


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


def _estimate_swap_prob(target, generator, beta_curr, beta_star,
                        n_samples: int) -> float:
    """a_hat = E[min(1, exp((beta_curr - beta_star)(logpi(x*) -
    logpi(x))))] with x* drawn tempered at ``beta_star`` and x at
    ``beta_curr`` (0-d float32 tensors), ``n_samples`` each.  The
    full-covariance MVN's log-density is a matmul, which runs in full
    float32 unless the caller turned TF32 on."""
    xs = target.direct_sample(n_samples, beta_star, generator)
    xc = target.direct_sample(n_samples, beta_curr, generator)
    log_r = (beta_curr - beta_star).to(xs.device) * (
        target.log_density(xs) - target.log_density(xc))
    return float(torch.mean(torch.exp(torch.clamp_max(log_r, 0.0))))


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
    """Iterative ladder construction, the JAX host loop step for step:
    per rung, probe beta* = beta / (1 + e^clip(pn)) until the estimated
    swap rate is within ``tolerance`` of the target (then take beta*),
    beta* falls below ``beta_min`` or ``max_pn_adjustment_steps`` probes
    are spent; an exhausted rung is still taken within ``tolerance *
    convergence_failure_tolerance_factor``; the ladder ends with
    ``beta_min``.  The target must have ``direct_sample``.  Probe ``i``
    (counted from 1 over the whole build) draws from
    ``step_generator(seed, i, device, stream=3)``."""
    try:
        target.direct_sample(1, 1.0, step_generator(seed, 0, target.device,
                                                    stream=_LADDER_STREAM))
    except NotImplementedError as e:
        raise NotImplementedError(
            "The target distribution must implement 'direct_sample(n, beta, "
            "generator)' for iterative temperature ladder construction.") \
            from e

    f32 = torch.float32
    ladder = [1.0]
    beta_curr = 1.0
    probe = 0

    def log(msg):
        if verbose:
            print(msg)

    while True:
        if beta_curr <= beta_min + 1e-6:
            break
        pn = initial_pn
        n_updates = 1
        found = False
        last_beta_star = -1.0
        last_a_hat = -1.0
        adj_iter = 0

        for adj_iter in range(1, max_pn_adjustment_steps + 1):
            clamped = float(np.clip(pn, *pn_clamping_range))
            if beta_curr < 1e-9:
                last_beta_star = -1.0
                break
            beta_star = beta_curr / (1.0 + math.exp(clamped))
            last_beta_star = beta_star
            if beta_star < beta_min:
                break

            probe += 1
            a_hat = float(_estimate_swap_prob(
                target, step_generator(seed, probe, target.device,
                                       stream=_LADDER_STREAM),
                torch.tensor(beta_curr, dtype=f32),
                torch.tensor(beta_star, dtype=f32), N_samples_swap_est))
            last_a_hat = a_hat
            log(f"  probe beta*={beta_star:.6f} a_hat={a_hat:.4f}")

            if abs(a_hat - target_swap_acceptance_rate) <= tolerance:
                ladder.append(beta_star)
                beta_curr = beta_star
                found = True
                break
            pn += (n_updates ** pn_update_power) * (
                a_hat - target_swap_acceptance_rate)
            n_updates += 1

        if not found:
            # an exhausted rung is taken within the widened tolerance
            if (adj_iter == max_pn_adjustment_steps
                    and last_beta_star >= beta_min
                    and last_beta_star != -1.0):
                wider = tolerance * convergence_failure_tolerance_factor
                if abs(last_a_hat - target_swap_acceptance_rate) <= wider:
                    log(f"  accepting beta*={last_beta_star:.6f} at wider "
                        "tol")
                    ladder.append(last_beta_star)
                    beta_curr = last_beta_star
                    continue
            break

    if ladder[-1] > beta_min + 1e-5:
        ladder.append(beta_min)
    return ladder
