"""Fused whole-run RWM: the CUDA kernel ``csrc/fused_rwm.cu`` and its plain
PyTorch version (port of ``rwm_pt_tpu.kernels.pallas_rwm.run_rwm_pallas``
with its recording variant, the Normal, Laplace and UniformRadius
proposals, ICDF draw).

``run_rwm_fused`` does the wrapper's bookkeeping (proposal scales, seeding,
resume, initial states, post-burn-in normalization) and hands the step loop
to :func:`launch_rwm_kernel` for CUDA tensors or to
:func:`_run_rwm_fused_plain` for CPU tensors.  Both consume the Philox
stream of :mod:`.draws` (slot layout there), so on the card they follow one
trajectory up to f32 rounding.  There is no fallback: a CUDA run launches
the kernel or raises.

Not ported yet (ROADMAP): the Box-Muller draw.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..utils.dtypes import as_tensor, resolve_device
from . import _build
from .draws import increment, n_records, resolve_seed, seed_key, step_draws
from .rwm import RWMResult, RWMState, step_generator


def _run_rwm_fused_plain(target, x0, acc0, jump0, beta, scale, key, step0,
                         total, burn_in, draws=None, *, kind="Normal",
                         record_every=0, record_chains=0):
    """Plain version of the kernel: ``total`` MH steps of every chain, step
    by step, with the kernel's arithmetic (int32 accepts after burn-in,
    Kahan-summed squared jumps).  ``beta`` is a 0-d f32 tensor, ``scale``
    the effective scale of proposal ``kind``: a 0-d std (Normal) or radius
    (UniformRadius), or the ``(d,)`` Laplace scales.  ``draws``, for tests:
    ``(increment draws (S, d, C), MH uniforms (S, C)[, radius uniforms
    (S, C)])`` in place of the Philox stream.  Returns
    ``(x, lp, acc, jump)``, and the trace ``(n_rec, d, record_chains)``
    after them when ``record_every`` is set."""
    d, C = x0.shape
    x = x0.clone()
    lp = target.log_density_td(x)
    acc = acc0.clone()
    jump = jump0.clone()
    comp = torch.zeros_like(jump)
    if kind == "Laplace":
        scale = scale[:, None]
    trace = []
    for s in range(total):
        abs_step = step0 + s + 1
        post = abs_step > burn_in
        if draws is None:
            inc, u, _, u_rad = step_draws(key, abs_step, 1, d, C, x.device,
                                          swap=False, kind=kind)
            inc, u = inc[0], u[0]
            u_rad = None if u_rad is None else u_rad[0]
        else:
            inc, u = draws[0][s], draws[1][s]
            u_rad = draws[2][s] if len(draws) > 2 else None
        prop = x + increment(kind, inc, u_rad, scale)
        lp_prop = target.log_density_td(prop)
        log_ratio = beta * (lp_prop - lp)
        accept = (log_ratio > 0.0) | (u < torch.exp(log_ratio))
        x_new = torch.where(accept[None], prop, x)
        lp = torch.where(accept, lp_prop, lp)
        if post:
            acc = acc + accept.to(torch.int32)
        step_jump = torch.sum(torch.square(x_new - x), dim=0)
        x = x_new
        y = (step_jump if post else torch.zeros_like(step_jump)) - comp
        tot = jump + y
        comp = (tot - jump) - y
        jump = tot
        if record_every and (s + 1) % record_every == 0:
            trace.append(x[:, :record_chains].clone())
    out = (x, lp, acc, jump)
    if record_every:
        out += (torch.stack(trace),)
    return out


def launch_rwm_kernel(target, x0, acc0, jump0, beta, scale, key, step0,
                      total, burn_in, *, kind="Normal", record_every=0,
                      record_chains=0):
    """Launch ``csrc/fused_rwm.cu`` (the library built for ``kind``) on the
    current stream; same arguments and results as
    :func:`_run_rwm_fused_plain`.  ``launches`` counts each launch under
    the library's name, and a recorded one also under
    ``fused_rwm_record``."""
    lib = _build.library("fused_rwm", kind)
    tkind, params = _build.kernel_target(target)
    params = params.to(x0.device)
    _build.check_cuda("fused_rwm", torch.float32, x0=x0, jump0=jump0,
                      params=params)
    _build.check_cuda("fused_rwm", torch.int32, acc0=acc0)
    d, C = x0.shape
    if target.dim != d:
        raise ValueError(f"x0 has {d} coordinates, the target {target.dim}")
    if (acc0.device != x0.device or tuple(acc0.shape) != (C,)
            or tuple(jump0.shape) != (C,)):
        raise ValueError("fused_rwm: accumulators must be (C,) on x0's "
                         "device")
    lap_ptr, scalar = 0, 0.0
    if kind == "Laplace":
        _build.check_cuda("fused_rwm", torch.float32, scale=scale)
        if tuple(scale.shape) != (d,) or scale.device != x0.device:
            raise ValueError("fused_rwm: Laplace scales must be (d,) on "
                             "x0's device")
        lap_ptr = scale.data_ptr()
    else:
        scalar = float(scale)
    n_rec = n_records(total, record_every)
    rec_ptr, chain = 0, None
    if n_rec:
        if not 1 <= record_chains <= C:
            raise ValueError(f"record_chains must be in [1, {C}]")
        chain = torch.empty((n_rec, d, record_chains), dtype=torch.float32,
                            device=x0.device)
        rec_ptr = chain.data_ptr()
    x = torch.empty_like(x0)
    lp = torch.empty(C, dtype=torch.float32, device=x0.device)
    acc = torch.empty_like(acc0)
    jump = torch.empty_like(jump0)
    fn = _build.entry(lib)
    rc = fn(tkind, params.data_ptr(), params.numel(), scalar, float(beta),
            x0.data_ptr(), acc0.data_ptr(), jump0.data_ptr(),
            x.data_ptr(), lp.data_ptr(), acc.data_ptr(), jump.data_ptr(),
            d, C, total, burn_in, step0, key[0], key[1], lap_ptr, 1.0 / d,
            rec_ptr, record_every or 0, record_chains if n_rec else 0,
            torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check_launch(lib, rc)
    launch_rwm_kernel.launches[lib] += 1
    if n_rec:
        launch_rwm_kernel.launches["fused_rwm_record"] += 1
        return x, lp, acc, jump, chain
    return x, lp, acc, jump


launch_rwm_kernel.launches = Counter()


def proposal_scale(proposal, base_variance, beta_t):
    """``(kind, effective scale)`` of a fused RWM run at inverse temperature
    ``beta_t`` (0-d f32), with the reference's laws: Normal std
    ``sqrt(base_variance / beta)``, Laplace scales
    ``sqrt(base_variance_vector / beta / 2)``, UniformRadius radius
    ``base_radius / sqrt(beta)``."""
    f32, dev = torch.float32, beta_t.device
    kind = "Normal" if proposal is None else proposal.name
    _build.library("fused_rwm", kind)     # raises for any other proposal
    if kind == "Normal":
        base = (base_variance if proposal is None
                else proposal.base_variance_scalar)
        return kind, torch.sqrt(torch.as_tensor(base, dtype=f32).to(dev)
                                / beta_t)
    if kind == "Laplace":
        v = proposal.base_variance_vector.to(dev, f32)
        return kind, torch.sqrt(v / beta_t / 2.0).contiguous()
    return kind, proposal.base_radius.to(dev, f32) / torch.sqrt(beta_t)


def run_rwm_fused(target, seed, *, base_variance: float | None = None,
                  proposal=None, num_chains: int, num_iterations: int,
                  burn_in: int = 0, beta: float = 1.0, init_states=None,
                  resume_state: RWMState | None = None,
                  record_every: int | None = None, record_chains: int = 1,
                  device="cuda", draws=None) -> RWMResult:
    """Fused RWM run with the metrics contract of ``run_rwm``.

    ``proposal`` (a ``NormalProposal``, ``LaplaceProposal`` or
    ``UniformRadiusProposal``) or the ``base_variance`` shorthand for a
    Normal proposal of effective std ``sqrt(base_variance / beta)``.
    ``seed``: ``int`` or ``torch.Generator``.  ``resume_state`` continues a
    previous state for ``num_iterations`` more steps; the Philox counter
    carries the absolute step, so the continuation draws what an
    uninterrupted run would have.  ``record_every``: trace ``chain`` of the
    first ``record_chains`` chains after every ``record_every``-th step of
    this launch, ``(total // record_every, d, record_chains)``; a
    ``record_every`` beyond the launch's steps raises.  ``draws`` (CPU
    only, for tests) replaces the Philox stream."""
    dev = resolve_device(device)
    if proposal is None and base_variance is None:
        raise ValueError("pass either base_variance or a proposal")
    if dev.type == "cuda" and draws is not None:
        raise ValueError("draws= replaces the Philox stream on the CPU only")
    f32 = torch.float32
    target = target.to(dev, f32)
    seed = resolve_seed(seed)
    if resume_state is not None:
        x0 = resume_state.x.to(dev, f32).contiguous()
        acc0 = resume_state.accept_count.to(dev, torch.int32).contiguous()
        jump0 = resume_state.sum_sq_jump.to(dev, f32).contiguous()
        step0 = int(resume_state.step)
        total = num_iterations
    else:
        if init_states is None:
            g = step_generator(seed, -1, dev, stream=1)
            x0 = target.init_sample(num_chains, g).T.contiguous()
        else:
            x0 = as_tensor(init_states, dev, f32).contiguous()
        C = x0.shape[1]
        acc0 = torch.zeros(C, dtype=torch.int32, device=dev)
        jump0 = torch.zeros(C, dtype=f32, device=dev)
        step0 = 0
        total = burn_in + num_iterations
    n_records(total, record_every)
    if record_every and not 1 <= record_chains <= x0.shape[1]:
        raise ValueError(f"record_chains must be in [1, {x0.shape[1]}]")
    beta_t = torch.tensor(float(beta), dtype=f32, device=dev)
    kind, scale = proposal_scale(proposal, base_variance, beta_t)
    key = seed_key(seed)
    args = (target, x0, acc0, jump0, beta_t, scale, key, step0, total,
            burn_in)
    kw = dict(kind=kind, record_every=record_every or 0,
              record_chains=record_chains)
    if dev.type == "cpu":
        out = _run_rwm_fused_plain(*args, draws=draws, **kw)
    else:
        out = launch_rwm_kernel(*args, **kw)
    x, lp, acc, jump = out[:4]
    n = max(step0 + total - burn_in, 1)
    state = RWMState(x=x, logp=lp, accept_count=acc, sum_sq_jump=jump,
                     step=step0 + total)
    return RWMResult(state=state, acceptance_rate=acc / n, esjd=jump / n,
                     chain=out[4] if record_every else None)
