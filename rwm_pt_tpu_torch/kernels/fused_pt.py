"""Fused whole-run Parallel Tempering: the CUDA kernel ``csrc/fused_pt.cu``
and its plain PyTorch version (port of
``rwm_pt_tpu.kernels.pallas_pt.run_pt_pallas`` with its cold-chain
recording variant, the Normal, Laplace and UniformRadius proposals, ICDF
draw).

``run_pt_fused`` does the wrapper's bookkeeping (per-rung scales, seeding,
resume, initial states, analytic swap attempts, post-burn-in normalization)
and hands the step loop to :func:`launch_pt_kernel` for CUDA tensors or to
:func:`_run_pt_fused_plain` for CPU tensors.  Both consume the Philox
stream of :mod:`.draws`, so on the card they follow one trajectory up to
f32 rounding.  There is no fallback: a CUDA run launches the kernel or
raises.

Not ported yet (ROADMAP): the Box-Muller draw.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..utils.dtypes import as_tensor, resolve_device
from . import _build
from .draws import increment, n_records, resolve_seed, seed_key, step_draws
from .pt import PTResult, PTState
from .rwm import step_generator


def _run_pt_fused_plain(target, x0, acc0, swapacc0, betajump0, coldjump0,
                        betas, sigmas, key, step0, total, burn_in,
                        swap_every, draws=None, *, kind="Normal",
                        record_every=0, record_chains=0):
    """Plain version of the kernel, step by step with its arithmetic: MH on
    every rung; on post-burn-in multiples of ``swap_every`` the sequential
    sweep j = 0..T-2; int32 counts; Kahan-compensated beta-jump and
    cold-jump sums (the compensation steps run on every step, as in the
    kernel body ``pallas_pt.py::_pt_body_fn``).

    ``x0`` is ``(d, T, C)``; ``betas`` f32 ``(T,)``; ``sigmas`` the
    per-rung scales of proposal ``kind``: f32 ``(T,)`` stds (Normal) or
    radii (UniformRadius), or ``(T, d)`` Laplace scales.  ``draws``, for
    tests: ``(increment draws (S, T, d, C), MH uniforms (S, T, C), swap
    uniforms (S, T-1, C)[, radius uniforms (S, T, C)])`` in place of the
    Philox stream.  Returns ``(x, lp, acc, swapacc, betajump, coldjump)``,
    and after them, when ``record_every`` is set, the trace
    ``(n_rec, d, record_chains)`` of rung 0 taken after the swap sweep of
    every ``record_every``-th step."""
    d, T, C = x0.shape
    scale = (sigmas.T[:, :, None] if kind == "Laplace"
             else sigmas[:, None] if kind == "UniformRadius"
             else sigmas[None, :, None])
    trace = []
    x = x0.clone()
    lp = target.log_density_td(x)
    acc = acc0.clone()
    swapacc = swapacc0.clone()
    bj, cj = betajump0.clone(), coldjump0.clone()
    bc, cc = torch.zeros_like(bj), torch.zeros_like(cj)
    no_swap = torch.zeros(C, dtype=torch.bool, device=x.device)
    for s in range(total):
        abs_step = step0 + s + 1
        post = abs_step > burn_in
        do_swap = post and abs_step % swap_every == 0
        if draws is None:
            inc, u_mh, u_sw, u_rad = step_draws(key, abs_step, T, d, C,
                                                x.device, kind=kind)
        else:
            inc, u_mh, u_sw = draws[0][s], draws[1][s], draws[2][s]
            u_rad = draws[3][s] if len(draws) > 3 else None
        cold_before = x[:, 0].clone()
        # ---- MH move, every rung
        prop = x + increment(kind, inc.permute(1, 0, 2), u_rad, scale)
        lp_prop = target.log_density_td(prop)
        log_ratio = betas[:, None] * (lp_prop - lp)
        accept = (log_ratio > 0.0) | (u_mh < torch.exp(log_ratio))
        x = torch.where(accept[None], prop, x)
        lp = torch.where(accept, lp_prop, lp)
        if post:
            acc = acc + accept.to(torch.int32)
        # ---- sequential swap sweep (compensation steps on every step)
        for j in range(T - 1):
            db = betas[j] - betas[j + 1]
            if do_swap:
                sw = u_sw[j] < torch.exp(db * (lp[j + 1] - lp[j]))
                xj, xk = x[:, j].clone(), x[:, j + 1].clone()
                x[:, j] = torch.where(sw[None], xk, xj)
                x[:, j + 1] = torch.where(sw[None], xj, xk)
                lpj, lpk = lp[j].clone(), lp[j + 1].clone()
                lp[j] = torch.where(sw, lpk, lpj)
                lp[j + 1] = torch.where(sw, lpj, lpk)
                swapacc = swapacc + sw.to(torch.int32)
            else:
                sw = no_swap
            y = torch.where(sw, db * db, 0.0) - bc
            tot = bj + y
            bc = (tot - bj) - y
            bj = tot
        # ---- cold-rung squared jump, swap moves included
        step_jump = torch.sum(torch.square(x[:, 0] - cold_before), dim=0)
        y = (step_jump if post else torch.zeros_like(step_jump)) - cc
        tot = cj + y
        cc = (tot - cj) - y
        cj = tot
        if record_every and (s + 1) % record_every == 0:
            trace.append(x[:, 0, :record_chains].clone())
    out = (x, lp, acc, swapacc, bj, cj)
    if record_every:
        out += (torch.stack(trace),)
    return out


def launch_pt_kernel(target, x0, acc0, swapacc0, betajump0, coldjump0,
                     betas, sigmas, key, step0, total, burn_in, swap_every,
                     *, kind="Normal", record_every=0, record_chains=0):
    """Launch ``csrc/fused_pt.cu`` (the library built for ``kind``) on the
    current stream; same arguments and results as
    :func:`_run_pt_fused_plain`.  ``launches`` counts each launch under
    the library's name, and a recorded one also under
    ``fused_pt_record``."""
    lib = _build.library("fused_pt", kind)
    tkind, params = _build.kernel_target(target)
    params = params.to(x0.device)
    d, T, C = x0.shape
    if target.dim != d:
        raise ValueError(f"x0 has {d} coordinates, the target {target.dim}")
    if T > _build.MAX_RUNGS:
        raise NotImplementedError(
            f"fused PT runs one thread per (replica, rung), at most "
            f"{_build.MAX_RUNGS} rungs; T={T}")
    _build.check_cuda("fused_pt", torch.float32, x0=x0, betajump0=betajump0,
                      coldjump0=coldjump0, betas=betas, sigmas=sigmas,
                      params=params)
    _build.check_cuda("fused_pt", torch.int32, acc0=acc0, swapacc0=swapacc0)
    shapes = [(acc0, (T, C)), (swapacc0, (C,)), (betajump0, (C,)),
              (coldjump0, (C,)), (betas, (T,)),
              (sigmas, (T, d) if kind == "Laplace" else (T,))]
    if acc0.device != x0.device or any(tuple(t.shape) != s
                                       for t, s in shapes):
        raise ValueError("fused_pt: accumulators must be (T, C) / (C,), "
                         "betas (T,) and the scales (T,) or, for Laplace, "
                         "(T, d), on x0's device")
    n_rec = n_records(total, record_every)
    rec_ptr, chain = 0, None
    if n_rec:
        if not 1 <= record_chains <= C:
            raise ValueError(f"record_chains must be in [1, {C}]")
        chain = torch.empty((n_rec, d, record_chains), dtype=torch.float32,
                            device=x0.device)
        rec_ptr = chain.data_ptr()
    x = torch.empty_like(x0)
    lp = torch.empty((T, C), dtype=torch.float32, device=x0.device)
    acc = torch.empty_like(acc0)
    swapacc = torch.empty_like(swapacc0)
    bj = torch.empty_like(betajump0)
    cj = torch.empty_like(coldjump0)
    fn = _build.entry(lib)
    rc = fn(tkind, params.data_ptr(), params.numel(), betas.data_ptr(),
            sigmas.data_ptr(), x0.data_ptr(), acc0.data_ptr(),
            swapacc0.data_ptr(), betajump0.data_ptr(), coldjump0.data_ptr(),
            x.data_ptr(), lp.data_ptr(), acc.data_ptr(), swapacc.data_ptr(),
            bj.data_ptr(), cj.data_ptr(), d, T, C, total, burn_in,
            swap_every, step0, key[0], key[1],
            sigmas.data_ptr() if kind == "Laplace" else 0, 1.0 / d,
            rec_ptr, record_every or 0, record_chains if n_rec else 0,
            torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check_launch(lib, rc)
    launch_pt_kernel.launches[lib] += 1
    if n_rec:
        launch_pt_kernel.launches["fused_pt_record"] += 1
        return x, lp, acc, swapacc, bj, cj, chain
    return x, lp, acc, swapacc, bj, cj


launch_pt_kernel.launches = Counter()


def rung_scales(proposal, base_variance, betas, mult):
    """``(kind, per-rung scales)`` of a fused PT run, with the reference's
    laws and per-rung variance multipliers ``mult`` (all f32 ``(T,)``):
    Normal stds ``sqrt(base * c / beta)``, UniformRadius radii
    ``R * sqrt(c) / sqrt(beta)``, Laplace scales
    ``sqrt(v_i * c_t / beta_t / 2)`` as ``(T, d)``
    (``pallas_pt.py:307-320``)."""
    f32, dev = torch.float32, betas.device
    kind = "Normal" if proposal is None else proposal.name
    _build.library("fused_pt", kind)      # raises for any other proposal
    if kind == "Normal":
        base = (base_variance if proposal is None
                else proposal.base_variance_scalar)
        scales = torch.sqrt(torch.as_tensor(base, dtype=f32).to(dev) * mult
                            / betas)
    elif kind == "UniformRadius":
        scales = (proposal.base_radius.to(dev, f32) * torch.sqrt(mult)
                  / torch.sqrt(betas))
    else:
        v = proposal.base_variance_vector.to(dev, f32)
        scales = torch.sqrt(v[None, :] * mult[:, None] / betas[:, None]
                            / 2.0)
    return kind, scales.contiguous()


def run_pt_fused(target, seed, betas, *, base_variance: float | None = None,
                 proposal=None, num_chains: int, num_iterations: int,
                 burn_in: int = 0, swap_every: int = 100, init_states=None,
                 resume_state: PTState | None = None, scale_multipliers=None,
                 record_every: int | None = None, record_chains: int = 1,
                 device="cuda", draws=None) -> PTResult:
    """Fused PT run with the metrics contract of ``run_pt``.

    ``proposal`` (a ``NormalProposal``, ``LaplaceProposal`` or
    ``UniformRadiusProposal``) or the ``base_variance`` shorthand for a
    Normal proposal.  Per-rung scales follow the reference's laws with
    ``scale_multipliers`` ``c`` (ones by default): variance
    ``base * c_t / beta_t`` (Normal, Laplace), radius
    ``R sqrt(c_t) / sqrt(beta_t)`` (UniformRadius).  ``init_states``:
    ``(d, T, C)``.  ``resume_state`` continues a previous state for
    ``num_iterations`` more steps (the Philox counter carries the absolute
    step).  Segments with ``swap_every`` beyond their last step run MH
    moves only.  Swap attempts are counted analytically: ``T-1`` per swap
    step in ``(burn_in, step]``.  ``record_every``: trace ``chain`` of rung
    0 (the cold chain) of the first ``record_chains`` replicas, taken after
    the swap sweep of every ``record_every``-th step of this launch,
    ``(total // record_every, d, record_chains)``; a ``record_every`` beyond
    the launch's steps raises.  ``draws`` (CPU only, for tests) replaces
    the Philox stream."""
    dev = resolve_device(device)
    if proposal is None and base_variance is None:
        raise ValueError("pass either base_variance or a proposal")
    if dev.type == "cuda" and draws is not None:
        raise ValueError("draws= replaces the Philox stream on the CPU only")
    f32 = torch.float32
    target = target.to(dev, f32)
    seed = resolve_seed(seed)
    betas = as_tensor(betas, dev, f32).contiguous()
    T = betas.shape[0]
    if resume_state is not None:
        x0 = resume_state.x.to(dev, f32).contiguous()
        acc0 = resume_state.accept_count.to(dev, torch.int32).contiguous()
        swapacc0 = resume_state.swap_accept_count.to(
            dev, torch.int32).contiguous()
        bj0 = resume_state.sum_beta_sq_jump.to(dev, f32).contiguous()
        cj0 = resume_state.sum_sq_jump_cold.to(dev, f32).contiguous()
        step0 = int(resume_state.step)
        total = num_iterations
    else:
        if init_states is None:
            g = step_generator(seed, -1, dev, stream=1)
            xi = target.init_sample(num_chains, g).T
            x0 = xi[:, None, :].expand(target.dim, T, num_chains)
        else:
            x0 = as_tensor(init_states, dev, f32)
        x0 = x0.contiguous()
        C = x0.shape[2]
        acc0 = torch.zeros((T, C), dtype=torch.int32, device=dev)
        swapacc0 = torch.zeros(C, dtype=torch.int32, device=dev)
        bj0 = torch.zeros(C, dtype=f32, device=dev)
        cj0 = torch.zeros(C, dtype=f32, device=dev)
        step0 = 0
        total = burn_in + num_iterations
    n_records(total, record_every)
    if record_every and not 1 <= record_chains <= x0.shape[2]:
        raise ValueError(f"record_chains must be in [1, {x0.shape[2]}]")
    mult = (torch.ones_like(betas) if scale_multipliers is None
            else as_tensor(scale_multipliers, dev, f32))
    kind, sigmas = rung_scales(proposal, base_variance, betas, mult)
    key = seed_key(seed)
    args = (target, x0, acc0, swapacc0, bj0, cj0, betas, sigmas, key, step0,
            total, burn_in, swap_every)
    kw = dict(kind=kind, record_every=record_every or 0,
              record_chains=record_chains)
    if dev.type == "cpu":
        out = _run_pt_fused_plain(*args, draws=draws, **kw)
    else:
        out = launch_pt_kernel(*args, **kw)
    x, lp, acc, swapacc, bj, cj = out[:6]
    n = float(max(step0 + total - burn_in, 1))
    n_events = (step0 + total) // swap_every - burn_in // swap_every
    attempts = max(n_events * (T - 1), 1)
    state = PTState(x=x, logp=lp, accept_count=acc,
                    swap_attempt_count=attempts, swap_accept_count=swapacc,
                    sum_beta_sq_jump=bj, sum_sq_jump_cold=cj,
                    step=step0 + total)
    return PTResult(state=state,
                    swap_acceptance_rate=swapacc / attempts,
                    pt_esjd=bj / attempts,
                    cold_esjd=cj / n,
                    acceptance_rate=acc / n,
                    chain=out[6] if record_every else None)
