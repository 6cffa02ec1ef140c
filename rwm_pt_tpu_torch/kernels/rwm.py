"""Eager Random Walk Metropolis engine (port of ``rwm_pt_tpu.kernels.rwm``).

A batch of ``C`` independent chains, laid out ``(dim, C)``, advances in
lockstep; each step is a handful of PyTorch operations.  Acceptance counts
and ESJD accumulate online after burn-in.  Every step draws from its own
``torch.Generator`` seeded by (seed, absolute step), so a resumed run draws
the stream an uninterrupted run would have drawn.

``symmetric=False`` adds the proposal's ``log q(x|y) - log q(y|x)``
(``Proposal.log_q_ratio``) to the accept ratio; ``progress_every`` prints
JAX's progress lines between steps (:func:`maybe_report_progress`), which
leaves the run unchanged; ``unroll`` is accepted and ignored (it tuned
JAX's compiled loop).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from ..utils.dtypes import as_tensor, default_float, resolve_device
from .draws import resolve_seed

_MIX_A = 0x9E3779B97F4A7C15
_MIX_B = 0xBF58476D1CE4E5B9
_SEED_MASK = (1 << 63) - 1


def step_generator(seed: int, step: int, device, stream: int = 0):
    """``torch.Generator`` on ``device`` seeded from (seed, step, stream):
    the per-step randomness of the eager engines."""
    s = ((seed * _MIX_A) ^ ((step + 1) * _MIX_B) ^ (stream << 17)) \
        & _SEED_MASK
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


# per-run progress state: run id -> (last step, last wall time); at most 64
# runs, the oldest evicted first
_progress_state: dict = {}


def _progress_report(run_id, step, end):
    """One progress line of a run (JAX's ``rwm.py::_progress_report``):
    the step, and after the first line the rate in steps a second a chain
    since the run's last line."""
    run_id, step, end = int(run_id), int(step), int(end)
    now = time.time()
    last = _progress_state.get(run_id)
    if last and last[0] < step and last[1] < now:
        rate = (step - last[0]) / (now - last[1])
        print(f"  progress: step {step:,}/{end:,} "
              f"({rate:,.0f} steps/s/chain)", flush=True)
    else:
        print(f"  progress: step {step:,}/{end:,}", flush=True)
    while len(_progress_state) >= 64 and run_id not in _progress_state:
        _progress_state.pop(next(iter(_progress_state)))
    _progress_state[run_id] = (step, now)


def maybe_report_progress(step, end, progress_every, run_id=0):
    """A progress line when ``step`` is a multiple of ``progress_every``
    (nothing when it is falsy)."""
    if progress_every and step % progress_every == 0:
        _progress_report(run_id, step, end)


def progress_run_id(seed: int) -> int:
    """A run's progress id: the low 31 bits of its seed."""
    return int(seed) & 0x7FFFFFFF


def uniform(shape, generator, dtype) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=dtype)


def stack_trace(trace, record_every, like):
    """``(n_rec, *like.shape)`` thinned trace, or None without recording."""
    if not record_every:
        return None
    return torch.stack(trace) if trace else like.new_zeros(
        (0,) + tuple(like.shape))


@dataclasses.dataclass
class RWMState:
    """Carried state of a batched RWM run."""
    x: torch.Tensor             # (d, C) current states
    logp: torch.Tensor          # (C,) cached log densities
    accept_count: torch.Tensor  # (C,) int32, post burn-in accepts
    sum_sq_jump: torch.Tensor   # (C,) post burn-in sum ||x_{t+1}-x_t||^2
    step: int                   # steps taken so far


class RWMResult(NamedTuple):
    state: RWMState
    acceptance_rate: torch.Tensor   # (C,)
    esjd: torch.Tensor              # (C,)
    chain: Optional[torch.Tensor]   # (n_rec, d, C_rec) thinned trace or None


def rwm_init(target, generator, num_chains: int,
             init_states=None) -> RWMState:
    """Chains start at ``target.init_sample`` or at ``init_states``
    (``(d, C)``, or ``(d,)`` broadcast over the chains)."""
    dev = target.device
    if init_states is None:
        x0 = target.init_sample(num_chains, generator).T.contiguous()
    else:
        x0 = as_tensor(init_states, dev, default_float())
        if x0.ndim == 1:
            x0 = x0[:, None].expand(target.dim, num_chains).contiguous()
    C = x0.shape[1]
    return RWMState(x=x0, logp=target.log_density_td(x0),
                    accept_count=torch.zeros(C, dtype=torch.int32,
                                             device=dev),
                    sum_sq_jump=torch.zeros(C, dtype=x0.dtype, device=dev),
                    step=0)


def _rwm_step_core(state: RWMState, generator, target, proposal, beta,
                   burn_in: int, beta_proposal=None, symmetric: bool = True):
    """:func:`rwm_step` that also returns the ``(C,)`` accept mask."""
    C = state.x.shape[1]
    inc = proposal.sample_td(
        generator, beta if beta_proposal is None else beta_proposal, (C,))
    prop = state.x + inc
    lp_prop = target.log_density_td(prop)
    log_ratio = beta * (lp_prop - state.logp)
    if not symmetric:
        log_ratio = log_ratio + proposal.log_q_ratio(inc, beta)
    u = uniform((C,), generator, state.x.dtype)
    accept = (log_ratio > 0.0) | (u < torch.exp(log_ratio))
    x_new = torch.where(accept[None, :], prop, state.x)
    lp_new = torch.where(accept, lp_prop, state.logp)
    post = state.step + 1 > burn_in
    acc, ssj = state.accept_count, state.sum_sq_jump
    if post:
        acc = acc + accept.to(torch.int32)
        ssj = ssj + torch.sum(torch.square(x_new - state.x), dim=0)
    return RWMState(x=x_new, logp=lp_new, accept_count=acc,
                    sum_sq_jump=ssj, step=state.step + 1), accept


def rwm_step(state: RWMState, generator, target, proposal, beta,
             burn_in: int, beta_proposal=None,
             symmetric: bool = True) -> RWMState:
    """One MH step for all chains: accept if ``r > 0`` or ``u < exp(r)``
    with ``r = beta (logpi(y) - logpi(x))`` (plus the proposal's
    correction when not ``symmetric``); NaN rejects.
    ``beta_proposal`` rescales only the increment draw (the adaptive
    tuner's multiplier, :mod:`.adapt`); the accept ratio keeps ``beta``."""
    return _rwm_step_core(state, generator, target, proposal, beta, burn_in,
                          beta_proposal, symmetric)[0]


def run_rwm(target, proposal, seed, *, num_chains: int,
            num_iterations: int, burn_in: int = 0, beta: float = 1.0,
            init_states=None, resume_state: RWMState | None = None,
            record_every: int | None = None, record_chains: int = 1,
            unroll: int = 4, symmetric: bool = True,
            progress_every: int | None = None,
            device="cuda") -> RWMResult:
    """Run ``burn_in + num_iterations`` MH steps on ``num_chains`` chains
    (``num_iterations`` more steps when resuming).

    ``seed``: an ``int`` or a ``torch.Generator``.  ``record_every``:
    thinned trace of the first ``record_chains`` chains after every
    ``record_every``-th step.  Acceptance rate and ESJD divide by the
    cumulative post-burn-in step count.  ``symmetric``,
    ``progress_every`` and ``unroll`` as in the module docstring."""
    dev = resolve_device(device)
    target = target.to(dev)
    proposal = proposal.to(dev)
    seed = resolve_seed(seed)
    if resume_state is not None:
        state = resume_state
        total = num_iterations
    else:
        state = rwm_init(target, step_generator(seed, -1, dev, stream=1),
                         num_chains, init_states)
        total = burn_in + num_iterations
    beta = float(beta)
    trace = []
    end, run_id = state.step + total, progress_run_id(seed)
    for i in range(total):
        state = rwm_step(state, step_generator(seed, state.step, dev),
                         target, proposal, beta, burn_in,
                         symmetric=symmetric)
        maybe_report_progress(state.step, end, progress_every, run_id)
        if record_every and (i + 1) % record_every == 0:
            trace.append(state.x[:, :record_chains].clone())
    chain = stack_trace(trace, record_every, state.x[:, :record_chains])
    n = max(state.step - burn_in, 1)
    return RWMResult(state=state,
                     acceptance_rate=state.accept_count / n,
                     esjd=state.sum_sq_jump / n,
                     chain=chain)
