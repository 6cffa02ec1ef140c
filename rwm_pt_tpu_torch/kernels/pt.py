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

``cpu_semantics=True`` runs the reference's CPU PT step (JAX
``pt.py:281-300``): on every multiple of ``swap_every``, burn-in included,
the rungs swap instead of moving, and only the hottest rung takes its MH
move; per-rung acceptance then divides by the MH attempts each rung made
(:func:`pt_result`).  ``symmetric=False`` adds the proposal's ``log q(x|y) -
log q(y|x)`` to the MH ratio; ``progress_every`` prints JAX's progress
lines (``rwm.maybe_report_progress``), leaving the run unchanged;
``unroll`` is accepted and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from .draws import resolve_seed
from .rwm import (maybe_report_progress, progress_run_id, stack_trace,
                  step_generator, uniform)


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
              betas_proposal=None, rung_mask=None, symmetric: bool = True):
    """Batched MH move on every rung.  ``betas_proposal`` rescales only the
    increment draws (per-rung scale multipliers); the accept ratio uses the
    true ``betas``.  ``rung_mask`` ``(T,)``: rungs where it is False keep
    their state (the CPU semantics' swap steps).  Returns ``(new_state,
    accept_mask)``."""
    B = tuple(state.logp.shape)
    inc = proposal.sample_td(
        generator, betas if betas_proposal is None else betas_proposal, B)
    prop = state.x + inc
    lp_prop = target.log_density_td(prop)
    log_ratio = betas[:, None] * (lp_prop - state.logp)
    if not symmetric:
        log_ratio = log_ratio + proposal.log_q_ratio(inc, betas)
    u = uniform(B, generator, state.x.dtype)
    accept = (log_ratio > 0.0) | (u < torch.exp(log_ratio))
    if rung_mask is not None:
        accept = accept & rung_mask[:, None]
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


def _pt_step_core(state: PTState, generator, target, proposal, betas,
                  burn_in, swap_every, swap_sweep: str = "even_odd",
                  betas_proposal=None, cpu_semantics: bool = False,
                  symmetric: bool = True):
    """:func:`pt_step` that also returns the ``(T, C)`` MH accept mask."""
    if swap_sweep not in _SWEEPS:
        raise ValueError("swap_sweep must be 'even_odd' or 'sequential'")
    cold_before = state.x[:, 0, :]
    step_counter = state.step + 1
    post = step_counter > burn_in
    if cpu_semantics and step_counter % swap_every == 0:
        # swap first, then only the hottest rung moves
        state = _SWEEPS[swap_sweep](state, generator, betas)
        hot = torch.arange(betas.shape[0], device=betas.device) \
            == betas.shape[0] - 1
        state, accept = _mh_phase(state, generator, target, proposal, betas,
                                  burn_in, betas_proposal, rung_mask=hot,
                                  symmetric=symmetric)
    else:
        state, accept = _mh_phase(state, generator, target, proposal, betas,
                                  burn_in, betas_proposal,
                                  symmetric=symmetric)
        if not cpu_semantics and post and step_counter % swap_every == 0:
            state = _SWEEPS[swap_sweep](state, generator, betas)
    cold = state.sum_sq_jump_cold
    if post:
        cold = cold + torch.sum(torch.square(state.x[:, 0, :] - cold_before),
                                dim=0)
    return dataclasses.replace(state, sum_sq_jump_cold=cold,
                               step=step_counter), accept


def pt_step(state: PTState, generator, target, proposal, betas, burn_in,
            swap_every, swap_sweep: str = "even_odd",
            betas_proposal=None, cpu_semantics: bool = False,
            symmetric: bool = True) -> PTState:
    """One PT step: MH move on every rung, then, on post-burn-in multiples
    of ``swap_every``, a swap event (with ``cpu_semantics``, the module
    docstring's step)."""
    return _pt_step_core(state, generator, target, proposal, betas, burn_in,
                         swap_every, swap_sweep, betas_proposal,
                         cpu_semantics, symmetric)[0]


def pt_result(state: PTState, burn_in: int, chain=None,
              cpu_semantics: bool = False, swap_every: int = 1) -> PTResult:
    """Metrics with the reference normalizations: swap acceptance =
    accepts / attempts, beta-ESJD = sum (dbeta^2) / attempts, cold ESJD and
    per-rung acceptance over the cumulative post-burn-in steps; with
    ``cpu_semantics`` the rungs below the hottest attempted MH on the
    post-burn-in steps that were no swap step (JAX ``pt.py:432-442``)."""
    n = float(max(state.step - burn_in, 1))
    attempts = float(max(state.swap_attempt_count, 1))
    mh_attempts = n
    if cpu_semantics:
        T = state.logp.shape[0]
        n_swap = float(state.step // swap_every - burn_in // swap_every)
        mh_attempts = torch.full((T, 1), max(n - n_swap, 1.0),
                                 dtype=state.x.dtype, device=state.x.device)
        mh_attempts[T - 1] = n
    return PTResult(
        state=state,
        swap_acceptance_rate=state.swap_accept_count / attempts,
        pt_esjd=state.sum_beta_sq_jump / attempts,
        cold_esjd=state.sum_sq_jump_cold / n,
        acceptance_rate=state.accept_count / mh_attempts,
        chain=chain)


def run_pt(target, proposal, seed, betas, *, num_chains: int,
           num_iterations: int, burn_in: int = 0, swap_every: int = 100,
           init_states=None, record_every: int | None = None,
           record_chains: int = 1, resume_state: PTState | None = None,
           swap_sweep: str = "even_odd", scale_multipliers=None,
           unroll: int = 2, cpu_semantics: bool = False,
           symmetric: bool = True, progress_every: int | None = None,
           device="cuda") -> PTResult:
    """Run ``burn_in + num_iterations`` PT steps on ``num_chains`` replicas
    (``num_iterations`` more when resuming).

    ``seed``: an ``int`` or a ``torch.Generator``.  ``scale_multipliers``:
    optional ``(T,)`` per-rung multipliers ``c`` (effective proposal
    variance ``base * c_t / beta_t``); the accept ratio keeps the true
    betas.  ``record_every``: thinned trace of rung 0 of the first
    ``record_chains`` replicas.  ``cpu_semantics``, ``symmetric``,
    ``progress_every`` and ``unroll`` as in the module docstring."""
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
    end, run_id = state.step + total, progress_run_id(seed)
    for i in range(total):
        state = pt_step(state, step_generator(seed, state.step, dev), target,
                        proposal, betas, burn_in, swap_every, swap_sweep,
                        betas_prop, cpu_semantics, symmetric)
        maybe_report_progress(state.step, end, progress_every, run_id)
        if record_every and (i + 1) % record_every == 0:
            trace.append(state.x[:, 0, :record_chains].clone())
    return pt_result(state, burn_in,
                     stack_trace(trace, record_every,
                                 state.x[:, 0, :record_chains]),
                     cpu_semantics, swap_every)
