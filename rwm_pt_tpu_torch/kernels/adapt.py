"""Burn-in adaptation of the proposal scale and of the PT ladder (port of
``rwm_pt_tpu.kernels.adapt``).

The theory the reference studies puts the ESJD-optimal RWM scale at an
acceptance of about 0.234, so instead of sweeping 40 scales the tuners
steer to it during burn-in with a Robbins-Monro recursion on a log-scale
multiplier ``c`` (``log c += rate n^power (a_hat - a*)``, one update per
``adapt_every``-step window), then freeze it: the post-burn-in phase is an
exact MH chain at the tuned scale.  All three proposals scale with
temperature as the variance does (variance/beta, radius/sqrt(beta)), so a
multiplier ``c`` is an *effective* inverse temperature ``beta / c`` for the
increment draw alone; the accept ratio keeps the true beta.

* :func:`run_rwm_adaptive`: one multiplier for the batch of chains;
* :func:`run_pt_adaptive`: one multiplier per rung, from that rung's own
  windowed acceptance;
* :func:`run_pt_ladder_adaptive`: the ladder itself, parametrized by
  per-pair log-spacings ``rho`` (``beta_{t+1} = beta_t / (1 + e^rho_t)``),
  steered by swap acceptance measured on the running chains (measurement
  swaps every ``adapt_swap_every`` burn-in steps mix the state but touch no
  official counter), so it works for targets without a direct sampler.

These are eager engines, on the card or the CPU: one step is a handful of
PyTorch operations drawing from ``step_generator(seed, step, device,
stream=<the tuner's tag>)``, the tags being the constants JAX folds into
its key.  The multipliers, ``rho`` and the window sums stay device
tensors, and whether a step adapts depends on the host step counter alone,
so the loop never waits for the card.  ``unroll`` is accepted for the JAX
signature's sake and ignored: an eager loop has nothing to unroll.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from .draws import resolve_seed
from .pt import (PTResult, _mh_phase, _pt_step_core, _swap_half_sweep,
                 _swap_phase, pt_init, pt_result)
from .rwm import (RWMResult, _rwm_step_core, rwm_init, step_generator,
                  uniform)

# the tuners' stream tags (JAX's fold_in constants)
RWM_TAG, PT_TAG, LADDER_TAG = 0x414454, 0x414455, 0x4C414444


class AdaptiveRWMResult(NamedTuple):
    result: RWMResult
    tuned_scale_multiplier: torch.Tensor   # (): effective variance base * c
    tuned_acceptance_target: float


class AdaptivePTResult(NamedTuple):
    result: PTResult
    tuned_scale_multipliers: torch.Tensor  # (T,) per-rung c
    tuned_acceptance_target: float


class AdaptiveLadderPTResult(NamedTuple):
    result: PTResult
    tuned_betas: torch.Tensor              # (T,) adapted ladder
    tuned_swap_target: float


def _rm_update(log_c, window_acc, n_updates: int, target, power, rate):
    """One Robbins-Monro step on ``log c`` with gain ``rate *
    n_updates^power``: acceptance above target grows the scale.
    ``n_updates`` is the host's update count (1 for the first)."""
    gamma = rate * float(n_updates) ** power
    return log_c + gamma * (window_acc - target)


def _betas_from_rho(rho):
    """Ladder from per-pair log-spacings: ``beta_0 = 1``,
    ``beta_{t+1} = beta_t / (1 + e^rho_t)``; decreasing for any real
    ``rho``."""
    ratios = 1.0 / (1.0 + torch.exp(rho))
    return torch.cat([torch.ones(1, dtype=rho.dtype, device=rho.device),
                      torch.cumprod(ratios, dim=0)])


def _measured_swap(state, generator, betas):
    """A swap event (even then odd half-sweep) that mixes the state and
    touches no official counter; returns the state and the per-pair pooled
    acceptance ``(T-1,)``."""
    T, C = state.logp.shape
    u_even = uniform((T - 1, C), generator, state.x.dtype)
    u_odd = uniform((T - 1, C), generator, state.x.dtype)
    x, lp, a0 = _swap_half_sweep(state.x, state.logp, u_even, betas, 0)
    x, lp, a1 = _swap_half_sweep(x, lp, u_odd, betas, 1)
    pair_acc = torch.mean((a0 | a1).to(state.x.dtype), dim=1)
    return dataclasses.replace(state, x=x, logp=lp), pair_acc


def _setup(target, proposal, seed, device):
    dev = resolve_device(device)
    return dev, target.to(dev), proposal.to(dev), resolve_seed(seed)


def run_rwm_adaptive(target, proposal, seed, *, num_chains: int,
                     num_iterations: int, burn_in: int, beta: float = 1.0,
                     target_accept: float = 0.234, adapt_every: int = 100,
                     rm_power: float = -0.5, rm_rate: float = 3.0,
                     init_states=None, unroll: int = 2,
                     device="cuda") -> AdaptiveRWMResult:
    """RWM with the proposal scale tuned to ``target_accept`` during
    burn-in, then frozen: the rates and ESJD are exact MH at the tuned
    scale.  ``burn_in`` should hold a few ``adapt_every`` windows.
    ``seed``: ``int`` or ``torch.Generator``; ``unroll`` is ignored."""
    dev, target, proposal, seed = _setup(target, proposal, seed, device)
    f = default_float()
    state = rwm_init(target, step_generator(seed, -1, dev, stream=RWM_TAG),
                     num_chains, init_states)
    beta = float(beta)
    log_c = torch.zeros((), dtype=f, device=dev)
    win = torch.zeros((), dtype=f, device=dev)
    beta_prop, n_upd = beta / torch.exp(log_c), 0
    for _ in range(burn_in + num_iterations):
        state, accept = _rwm_step_core(
            state, step_generator(seed, state.step, dev, stream=RWM_TAG),
            target, proposal, beta, burn_in, beta_prop)
        if state.step > burn_in:
            continue
        win = win + torch.mean(accept.to(f))
        if state.step % adapt_every == 0:
            n_upd += 1
            log_c = _rm_update(log_c, win / adapt_every, n_upd,
                               target_accept, rm_power, rm_rate)
            win = torch.zeros_like(win)
            beta_prop = beta / torch.exp(log_c)
    n = max(state.step - burn_in, 1)
    res = RWMResult(state=state, acceptance_rate=state.accept_count / n,
                    esjd=state.sum_sq_jump / n, chain=None)
    return AdaptiveRWMResult(result=res,
                             tuned_scale_multiplier=torch.exp(log_c),
                             tuned_acceptance_target=target_accept)


def run_pt_adaptive(target, proposal, seed, betas, *, num_chains: int,
                    num_iterations: int, burn_in: int,
                    swap_every: int = 100, target_accept: float = 0.234,
                    adapt_every: int = 100, rm_power: float = -0.5,
                    rm_rate: float = 3.0, init_states=None, unroll: int = 1,
                    device="cuda") -> AdaptivePTResult:
    """PT with per-rung proposal scales, each tuned to ``target_accept``
    from its rung's windowed MH acceptance during burn-in.  Swap events are
    :func:`run_pt`'s even/odd half-sweeps after burn-in, so the sampled
    phase is exact MH + PT.  ``unroll`` is ignored."""
    dev, target, proposal, seed = _setup(target, proposal, seed, device)
    f = default_float()
    betas = as_tensor(betas, dev, f)
    T = betas.shape[0]
    state = pt_init(target, step_generator(seed, -1, dev, stream=PT_TAG),
                    betas, num_chains, init_states)
    log_c = torch.zeros(T, dtype=f, device=dev)
    win = torch.zeros(T, dtype=f, device=dev)
    betas_prop, n_upd = betas / torch.exp(log_c), 0
    for _ in range(burn_in + num_iterations):
        state, accept = _pt_step_core(
            state, step_generator(seed, state.step, dev, stream=PT_TAG),
            target, proposal, betas, burn_in, swap_every, "even_odd",
            betas_prop)
        if state.step > burn_in:
            continue
        win = win + torch.mean(accept.to(f), dim=1)
        if state.step % adapt_every == 0:
            n_upd += 1
            log_c = _rm_update(log_c, win / adapt_every, n_upd,
                               target_accept, rm_power, rm_rate)
            win = torch.zeros_like(win)
            betas_prop = betas / torch.exp(log_c)
    return AdaptivePTResult(result=pt_result(state, burn_in),
                            tuned_scale_multipliers=torch.exp(log_c),
                            tuned_acceptance_target=target_accept)


def run_pt_ladder_adaptive(target, proposal, seed, *, num_rungs: int,
                           num_chains: int, num_iterations: int,
                           burn_in: int, swap_every: int = 100,
                           adapt_swap_every: int = 10,
                           adapt_every: int = 100,
                           target_swap_accept: float = 0.234,
                           beta_min: float = 0.01, rm_power: float = -0.5,
                           rm_rate: float = 3.0, rho_clamp: float = 10.0,
                           init_states=None, unroll: int = 1,
                           device="cuda") -> AdaptiveLadderPTResult:
    """PT with the temperature ladder adapted during burn-in from swap
    acceptance measured on the running chains.

    The ladder starts geometric from 1 to ``beta_min`` over ``num_rungs``
    rungs.  During burn-in a measurement swap event fires every
    ``adapt_swap_every`` steps, and every ``adapt_every`` steps each pair's
    ``rho_t`` moves by ``gamma_n (a_hat_t - a*)`` (clamped to
    ``±rho_clamp``): acceptance above target spreads the rungs.  After
    burn-in the ladder freezes and production swaps every ``swap_every``
    steps carry the official accounting.  ``adapt_every`` must be a
    multiple of ``adapt_swap_every``; ``unroll`` is ignored."""
    if adapt_every % adapt_swap_every:
        raise ValueError("adapt_every must be a multiple of adapt_swap_every")
    dev, target, proposal, seed = _setup(target, proposal, seed, device)
    f = default_float()
    T = num_rungs
    # rho0 from the geometric ratio r = beta_min^(1/(T-1)): 1/(1+e^rho) = r
    r = float(beta_min) ** (1.0 / max(T - 1, 1))
    rho = torch.full((T - 1,), math.log(1.0 / r - 1.0), dtype=f, device=dev)
    betas_cur = _betas_from_rho(rho)
    state = pt_init(target, step_generator(seed, -1, dev, stream=LADDER_TAG),
                    betas_cur, num_chains, init_states)
    meas_per_window = adapt_every // adapt_swap_every
    win = torch.zeros(T - 1, dtype=f, device=dev)
    n_upd = 0
    for _ in range(burn_in + num_iterations):
        g = step_generator(seed, state.step, dev, stream=LADDER_TAG)
        step_counter = state.step + 1
        in_burn = step_counter <= burn_in
        cold_before = state.x[:, 0, :]
        state, _ = _mh_phase(state, g, target, proposal, betas_cur, burn_in)
        if in_burn and step_counter % adapt_swap_every == 0:
            state, pair_acc = _measured_swap(state, g, betas_cur)
            win = win + pair_acc
        if not in_burn and step_counter % swap_every == 0:
            state = _swap_phase(state, g, betas_cur)
        if in_burn and step_counter % adapt_every == 0:
            n_upd += 1
            rho = torch.clamp(
                _rm_update(rho, win / meas_per_window, n_upd,
                           target_swap_accept, rm_power, rm_rate),
                -rho_clamp, rho_clamp)
            win = torch.zeros_like(win)
            betas_cur = _betas_from_rho(rho)
        cold = state.sum_sq_jump_cold
        if not in_burn:
            cold = cold + torch.sum(
                torch.square(state.x[:, 0, :] - cold_before), dim=0)
        state = dataclasses.replace(state, sum_sq_jump_cold=cold,
                                    step=step_counter)
    return AdaptiveLadderPTResult(result=pt_result(state, burn_in),
                                  tuned_betas=betas_cur,
                                  tuned_swap_target=target_swap_accept)
