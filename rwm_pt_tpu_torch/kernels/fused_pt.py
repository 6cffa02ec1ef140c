"""Fused whole-run Parallel Tempering: the CUDA kernel ``csrc/fused_pt.cu``
and its plain PyTorch version (port of
``rwm_pt_tpu.kernels.pallas_pt.run_pt_pallas``, non-recording, Normal
proposal, ICDF draw).

``run_pt_fused`` does the wrapper's bookkeeping (per-rung scales, seeding,
resume, initial states, analytic swap attempts, post-burn-in normalization)
and hands the step loop to :func:`launch_pt_kernel` for CUDA tensors or to
:func:`_run_pt_fused_plain` for CPU tensors.  Both consume the Philox
stream of :mod:`.draws`, so on the card they follow one trajectory up to
f32 rounding.  There is no fallback: a CUDA run launches the kernel or
raises.

Not ported yet (ROADMAP): ``record_every`` (the recording kernel), the
Laplace and UniformRadius proposals, the Box-Muller draw.
"""
from __future__ import annotations

import torch

from ..utils.dtypes import as_tensor, resolve_device
from . import _build
from .draws import resolve_seed, seed_key, step_draws
from .pt import PTResult, PTState
from .rwm import step_generator


def _run_pt_fused_plain(target, x0, acc0, swapacc0, betajump0, coldjump0,
                        betas, sigmas, key, step0, total, burn_in,
                        swap_every, draws=None):
    """Plain version of the kernel, step by step with its arithmetic: MH on
    every rung; on post-burn-in multiples of ``swap_every`` the sequential
    sweep j = 0..T-2; int32 counts; Kahan-compensated beta-jump and
    cold-jump sums (the compensation steps run on every step, as in the
    kernel body ``pallas_pt.py::_pt_body_fn``).

    ``x0`` is ``(d, T, C)``; ``betas``/``sigmas`` f32 ``(T,)``.  ``draws``,
    for tests: ``(normals (S, T, d, C), MH uniforms (S, T, C), swap
    uniforms (S, T-1, C))`` in place of the Philox stream.  Returns
    ``(x, lp, acc, swapacc, betajump, coldjump)``."""
    d, T, C = x0.shape
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
            n, u_mh, u_sw = step_draws(key, abs_step, T, d, C, x.device)
        else:
            n, u_mh, u_sw = draws[0][s], draws[1][s], draws[2][s]
        cold_before = x[:, 0].clone()
        # ---- MH move, every rung
        prop = x + n.permute(1, 0, 2) * sigmas[None, :, None]
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
    return x, lp, acc, swapacc, bj, cj


def launch_pt_kernel(target, x0, acc0, swapacc0, betajump0, coldjump0,
                     betas, sigmas, key, step0, total, burn_in, swap_every):
    """Launch ``csrc/fused_pt.cu`` on the current stream; same arguments
    and results as :func:`_run_pt_fused_plain`."""
    kind, params = _build.kernel_target(target)
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
              (coldjump0, (C,)), (betas, (T,)), (sigmas, (T,))]
    if acc0.device != x0.device or any(tuple(t.shape) != s
                                       for t, s in shapes):
        raise ValueError("fused_pt: accumulators must be (T, C) / (C,) and "
                         "betas, sigmas (T,), on x0's device")
    x = torch.empty_like(x0)
    lp = torch.empty((T, C), dtype=torch.float32, device=x0.device)
    acc = torch.empty_like(acc0)
    swapacc = torch.empty_like(swapacc0)
    bj = torch.empty_like(betajump0)
    cj = torch.empty_like(coldjump0)
    fn = _build.entry("fused_pt")
    rc = fn(kind, params.data_ptr(), params.numel(), betas.data_ptr(),
            sigmas.data_ptr(), x0.data_ptr(), acc0.data_ptr(),
            swapacc0.data_ptr(), betajump0.data_ptr(), coldjump0.data_ptr(),
            x.data_ptr(), lp.data_ptr(), acc.data_ptr(), swapacc.data_ptr(),
            bj.data_ptr(), cj.data_ptr(), d, T, C, total, burn_in,
            swap_every, step0, key[0], key[1],
            torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check_launch("fused_pt", rc)
    launch_pt_kernel.launches += 1
    return x, lp, acc, swapacc, bj, cj


launch_pt_kernel.launches = 0


def run_pt_fused(target, seed, betas, *, base_variance: float | None = None,
                 proposal=None, num_chains: int, num_iterations: int,
                 burn_in: int = 0, swap_every: int = 100, init_states=None,
                 resume_state: PTState | None = None, scale_multipliers=None,
                 device="cuda", draws=None) -> PTResult:
    """Fused PT run with the metrics contract of ``run_pt``.

    ``proposal`` (a ``NormalProposal``) or the ``base_variance`` shorthand.
    Per-rung std ``sqrt(base * c_t / beta_t)`` with ``scale_multipliers``
    ``c`` (ones by default).  ``init_states``: ``(d, T, C)``.
    ``resume_state`` continues a previous state for ``num_iterations``
    more steps (the Philox counter carries the absolute step).  Segments
    with ``swap_every`` beyond their last step run MH moves only.  Swap
    attempts are counted analytically: ``T-1`` per swap step in
    ``(burn_in, step]``.  ``draws`` (CPU only, for tests) replaces the
    Philox stream."""
    dev = resolve_device(device)
    if proposal is None and base_variance is None:
        raise ValueError("pass either base_variance or a proposal")
    if proposal is not None and proposal.name != "Normal":
        raise NotImplementedError(
            f"fused PT takes the Normal proposal only; {proposal.name} "
            "waits for ROADMAP Queue B item 6/7")
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
    mult = (torch.ones_like(betas) if scale_multipliers is None
            else as_tensor(scale_multipliers, dev, f32))
    base = (base_variance if proposal is None
            else proposal.base_variance_scalar)
    sigmas = torch.sqrt(torch.as_tensor(base, dtype=f32).to(dev) * mult
                        / betas).contiguous()
    key = seed_key(seed)
    args = (target, x0, acc0, swapacc0, bj0, cj0, betas, sigmas, key, step0,
            total, burn_in, swap_every)
    if dev.type == "cpu":
        x, lp, acc, swapacc, bj, cj = _run_pt_fused_plain(*args, draws=draws)
    else:
        x, lp, acc, swapacc, bj, cj = launch_pt_kernel(*args)
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
                    chain=None)
