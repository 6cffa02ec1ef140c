"""Eager Parallel Tempering engine (port of ``rwm_pt_tpu.kernels.pt``).

The port's own oracle for the fused PT kernel.  State is ``(dim, T, C)``:
``T`` temperature rungs x ``C`` independent replicas, each carrying a full
ladder.  A step is an MH move on every rung, then, every ``swap_every``
steps after burn-in, one swap event over the ``T-1`` adjacent pairs:
``"even_odd"`` half-sweeps (the JAX scan engine's default) or the exact
``"sequential"`` sweep j = 0..T-2 that the fused kernel runs.  Swap
log-probability ``(beta_j - beta_{j+1})(logpi_{j+1} - logpi_j)``; beta-ESJD
accumulates ``(beta_j - beta_{j+1})^2`` per accepted swap; the cold-chain
ESJD includes swap moves.  One layout only: the JAX ``layout="flat"`` option
is a TPU sublane fix.

Not ported yet (ROADMAP): ``cpu_semantics``, ``symmetric=False``,
``progress_every``, ``unroll``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from .draws import resolve_seed
from .rwm import stack_trace, step_generator, uniform


@dataclasses.dataclass
class PTState:
    x: torch.Tensor                  # (d, T, C)
    logp: torch.Tensor               # (T, C)
    accept_count: torch.Tensor       # (T, C) int32, post burn-in MH accepts
    swap_attempt_count: int          # per-replica swap attempts
    swap_accept_count: torch.Tensor  # (C,) int32
    sum_beta_sq_jump: torch.Tensor   # (C,) beta-space ESJD numerator
    sum_sq_jump_cold: torch.Tensor   # (C,) x-space cold-chain jumps
    step: int


class PTResult(NamedTuple):
    state: PTState
    swap_acceptance_rate: torch.Tensor  # (C,)
    pt_esjd: torch.Tensor               # (C,) beta-space ESJD
    cold_esjd: torch.Tensor             # (C,) x-space cold-chain ESJD
    acceptance_rate: torch.Tensor       # (T, C) per-rung MH acceptance
    chain: Optional[torch.Tensor]       # (n_rec, d, C_rec) cold trace


def pt_init(target, generator, betas, num_chains: int,
            init_states=None) -> PTState:
    """All rungs start from the same ``target.init_sample`` point, or from
    ``init_states`` ``(d, T, C)``."""
    dev = target.device
    T = betas.shape[0]
    if init_states is None:
        x0 = target.init_sample(num_chains, generator).T
        x0 = x0[:, None, :].expand(target.dim, T, num_chains).contiguous()
    else:
        x0 = as_tensor(init_states, dev, default_float())
    C = x0.shape[2]
    f = x0.dtype
    return PTState(
        x=x0, logp=target.log_density_td(x0),
        accept_count=torch.zeros((T, C), dtype=torch.int32, device=dev),
        swap_attempt_count=0,
        swap_accept_count=torch.zeros(C, dtype=torch.int32, device=dev),
        sum_beta_sq_jump=torch.zeros(C, dtype=f, device=dev),
        sum_sq_jump_cold=torch.zeros(C, dtype=f, device=dev),
        step=0)


def _mh_phase(state: PTState, generator, target, proposal, betas, burn_in,
              betas_proposal=None):
    """Batched MH move on every rung.  ``betas_proposal`` rescales only the
    increment draws (per-rung scale multipliers); the accept ratio uses the
    true ``betas``.  Returns ``(new_state, accept_mask)``."""
    B = tuple(state.logp.shape)
    inc = proposal.sample_td(
        generator, betas if betas_proposal is None else betas_proposal, B)
    prop = state.x + inc
    lp_prop = target.log_density_td(prop)
    log_ratio = betas[:, None] * (lp_prop - state.logp)
    u = uniform(B, generator, state.x.dtype)
    accept = (log_ratio > 0.0) | (u < torch.exp(log_ratio))
    x_new = torch.where(accept[None], prop, state.x)
    lp_new = torch.where(accept, lp_prop, state.logp)
    acc = state.accept_count
    if state.step + 1 > burn_in:
        acc = acc + accept.to(torch.int32)
    return dataclasses.replace(state, x=x_new, logp=lp_new,
                               accept_count=acc), accept


def _swap_half_sweep(x, lp, u, betas, parity):
    """Attempt all adjacent pairs (j, j+1) with j % 2 == parity at once;
    ``u`` is ``(T-1, C)``.  Returns updated (x, lp) and the per-pair accept
    mask ``(T-1, C)``."""
    T, C = lp.shape
    log_swap = (betas[:-1] - betas[1:])[:, None] * (lp[1:] - lp[:-1])
    acc = u < torch.exp(log_swap)                  # NaN rejects
    pair_mask = (torch.arange(T - 1, device=lp.device) % 2) == parity
    acc = acc & pair_mask[:, None]
    pad = torch.zeros((1, C), dtype=torch.bool, device=lp.device)
    swap_up = torch.cat([acc, pad], dim=0)         # rung j takes j+1's state
    swap_dn = torch.cat([pad, acc], dim=0)         # rung j+1 takes j's state
    x_new = torch.where(swap_up[None], torch.roll(x, -1, dims=1),
                        torch.where(swap_dn[None], torch.roll(x, 1, dims=1),
                                    x))
    lp_new = torch.where(swap_up, torch.roll(lp, -1, dims=0),
                         torch.where(swap_dn, torch.roll(lp, 1, dims=0), lp))
    return x_new, lp_new, acc


def _swap_phase(state: PTState, generator, betas) -> PTState:
    """One swap event: even half-sweep, then odd half-sweep on the updated
    log-densities; T-1 attempted pairs."""
    T, C = state.logp.shape
    u_even = uniform((T - 1, C), generator, state.x.dtype)
    u_odd = uniform((T - 1, C), generator, state.x.dtype)
    x, lp, a0 = _swap_half_sweep(state.x, state.logp, u_even, betas, 0)
    x, lp, a1 = _swap_half_sweep(x, lp, u_odd, betas, 1)
    acc = a0 | a1
    dbeta = betas[:-1] - betas[1:]
    return dataclasses.replace(
        state, x=x, logp=lp,
        swap_attempt_count=state.swap_attempt_count + (T - 1),
        swap_accept_count=state.swap_accept_count
        + torch.sum(acc, dim=0, dtype=torch.int32),
        sum_beta_sq_jump=state.sum_beta_sq_jump
        + torch.sum(acc * (dbeta ** 2)[:, None], dim=0))


def _swap_phase_sequential(state: PTState, generator, betas) -> PTState:
    """One swap event with the exact in-order sweep j = 0..T-2: each pair
    sees the states left by the pairs before it, so a state can cascade up
    the ladder within one event."""
    T, C = state.logp.shape
    u = uniform((T - 1, C), generator, state.x.dtype)
    dbeta = betas[:-1] - betas[1:]
    x, lp = state.x.clone(), state.logp.clone()
    acc = torch.zeros(C, dtype=torch.int32, device=lp.device)
    bsq = torch.zeros(C, dtype=lp.dtype, device=lp.device)
    for j in range(T - 1):
        a = u[j] < torch.exp(dbeta[j] * (lp[j + 1] - lp[j]))
        xj, xk = x[:, j].clone(), x[:, j + 1].clone()
        x[:, j] = torch.where(a[None], xk, xj)
        x[:, j + 1] = torch.where(a[None], xj, xk)
        lpj, lpk = lp[j].clone(), lp[j + 1].clone()
        lp[j] = torch.where(a, lpk, lpj)
        lp[j + 1] = torch.where(a, lpj, lpk)
        acc = acc + a.to(torch.int32)
        bsq = bsq + a * dbeta[j] ** 2
    return dataclasses.replace(
        state, x=x, logp=lp,
        swap_attempt_count=state.swap_attempt_count + (T - 1),
        swap_accept_count=state.swap_accept_count + acc,
        sum_beta_sq_jump=state.sum_beta_sq_jump + bsq)


_SWEEPS = {"even_odd": _swap_phase, "sequential": _swap_phase_sequential}


def pt_step(state: PTState, generator, target, proposal, betas, burn_in,
            swap_every, swap_sweep: str = "even_odd",
            betas_proposal=None) -> PTState:
    """One PT step: MH move on every rung, then, on post-burn-in multiples
    of ``swap_every``, a swap event."""
    if swap_sweep not in _SWEEPS:
        raise ValueError("swap_sweep must be 'even_odd' or 'sequential'")
    cold_before = state.x[:, 0, :]
    step_counter = state.step + 1
    state, _ = _mh_phase(state, generator, target, proposal, betas, burn_in,
                         betas_proposal)
    post = step_counter > burn_in
    if post and step_counter % swap_every == 0:
        state = _SWEEPS[swap_sweep](state, generator, betas)
    cold = state.sum_sq_jump_cold
    if post:
        cold = cold + torch.sum(torch.square(state.x[:, 0, :] - cold_before),
                                dim=0)
    return dataclasses.replace(state, sum_sq_jump_cold=cold,
                               step=step_counter)


def pt_result(state: PTState, burn_in: int, chain=None) -> PTResult:
    """Metrics with the reference normalizations: swap acceptance =
    accepts / attempts, beta-ESJD = sum (dbeta^2) / attempts, cold ESJD and
    per-rung acceptance over the cumulative post-burn-in steps."""
    n = float(max(state.step - burn_in, 1))
    attempts = float(max(state.swap_attempt_count, 1))
    return PTResult(
        state=state,
        swap_acceptance_rate=state.swap_accept_count / attempts,
        pt_esjd=state.sum_beta_sq_jump / attempts,
        cold_esjd=state.sum_sq_jump_cold / n,
        acceptance_rate=state.accept_count / n,
        chain=chain)


def run_pt(target, proposal, seed, betas, *, num_chains: int,
           num_iterations: int, burn_in: int = 0, swap_every: int = 100,
           init_states=None, record_every: int | None = None,
           record_chains: int = 1, resume_state: PTState | None = None,
           swap_sweep: str = "even_odd", scale_multipliers=None,
           device="cuda") -> PTResult:
    """Run ``burn_in + num_iterations`` PT steps on ``num_chains`` replicas
    (``num_iterations`` more when resuming).

    ``seed``: an ``int`` or a ``torch.Generator``.  ``scale_multipliers``:
    optional ``(T,)`` per-rung multipliers ``c`` (effective proposal
    variance ``base * c_t / beta_t``); the accept ratio keeps the true
    betas.  ``record_every``: thinned trace of rung 0 of the first
    ``record_chains`` replicas."""
    dev = resolve_device(device)
    target = target.to(dev)
    proposal = proposal.to(dev)
    seed = resolve_seed(seed)
    betas = as_tensor(betas, dev, default_float())
    if resume_state is not None:
        state = resume_state
        total = num_iterations
    else:
        state = pt_init(target, step_generator(seed, -1, dev, stream=1),
                        betas, num_chains, init_states)
        total = burn_in + num_iterations
    betas_prop = None
    if scale_multipliers is not None:
        betas_prop = betas / as_tensor(scale_multipliers, dev, betas.dtype)
    trace = []
    for i in range(total):
        state = pt_step(state, step_generator(seed, state.step, dev), target,
                        proposal, betas, burn_in, swap_every, swap_sweep,
                        betas_prop)
        if record_every and (i + 1) % record_every == 0:
            trace.append(state.x[:, 0, :record_chains].clone())
    return pt_result(state, burn_in,
                     stack_trace(trace, record_every,
                                 state.x[:, 0, :record_chains]))
