"""Fused whole-run RWM: the CUDA kernel ``csrc/fused_rwm.cu`` and its plain
PyTorch version (port of ``rwm_pt_tpu.kernels.pallas_rwm.run_rwm_pallas``,
non-recording, Normal proposal, ICDF draw).

``run_rwm_fused`` does the wrapper's bookkeeping (seeding, resume, initial
states, post-burn-in normalization) and hands the step loop to
:func:`launch_rwm_kernel` for CUDA tensors or to :func:`_run_rwm_fused_plain`
for CPU tensors.  Both consume the Philox stream of :mod:`.draws` (slot
layout there), so on the card they follow one trajectory up to f32
rounding.  There is no fallback: a CUDA run launches the kernel or raises.

Not ported yet (ROADMAP): ``record_every`` (the recording kernel), the
Laplace and UniformRadius proposals, the Box-Muller draw.
"""
from __future__ import annotations

import torch

from ..utils.dtypes import as_tensor, resolve_device
from . import _build
from .draws import resolve_seed, seed_key, step_draws
from .rwm import RWMResult, RWMState, step_generator


def _run_rwm_fused_plain(target, x0, acc0, jump0, beta, sigma, key, step0,
                         total, burn_in, draws=None):
    """Plain version of the kernel: ``total`` MH steps of every chain, step
    by step, with the kernel's arithmetic (int32 accepts after burn-in,
    Kahan-summed squared jumps).  ``beta`` and ``sigma`` are 0-d f32
    tensors.  ``draws``, for tests: ``(normals (S, d, C), uniforms (S, C))``
    in place of the Philox stream.  Returns ``(x, lp, acc, jump)``."""
    d, C = x0.shape
    x = x0.clone()
    lp = target.log_density_td(x)
    acc = acc0.clone()
    jump = jump0.clone()
    comp = torch.zeros_like(jump)
    for s in range(total):
        abs_step = step0 + s + 1
        post = abs_step > burn_in
        if draws is None:
            n, u, _ = step_draws(key, abs_step, 1, d, C, x.device, swap=False)
            n, u = n[0], u[0]
        else:
            n, u = draws[0][s], draws[1][s]
        prop = x + n * sigma
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
    return x, lp, acc, jump


def launch_rwm_kernel(target, x0, acc0, jump0, beta, sigma, key, step0,
                      total, burn_in):
    """Launch ``csrc/fused_rwm.cu`` on the current stream; same arguments
    and results as :func:`_run_rwm_fused_plain`."""
    kind, params = _build.kernel_target(target)
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
    x = torch.empty_like(x0)
    lp = torch.empty(C, dtype=torch.float32, device=x0.device)
    acc = torch.empty_like(acc0)
    jump = torch.empty_like(jump0)
    fn = _build.entry("fused_rwm")
    rc = fn(kind, params.data_ptr(), params.numel(), float(sigma),
            float(beta), x0.data_ptr(), acc0.data_ptr(), jump0.data_ptr(),
            x.data_ptr(), lp.data_ptr(), acc.data_ptr(), jump.data_ptr(),
            d, C, total, burn_in, step0, key[0], key[1],
            torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check_launch("fused_rwm", rc)
    launch_rwm_kernel.launches += 1
    return x, lp, acc, jump


launch_rwm_kernel.launches = 0


def run_rwm_fused(target, seed, *, base_variance: float | None = None,
                  proposal=None, num_chains: int, num_iterations: int,
                  burn_in: int = 0, beta: float = 1.0, init_states=None,
                  resume_state: RWMState | None = None, device="cuda",
                  draws=None) -> RWMResult:
    """Fused RWM run with the metrics contract of ``run_rwm``.

    ``proposal`` (a ``NormalProposal``) or the ``base_variance`` shorthand:
    effective std ``sqrt(base_variance / beta)``.  ``seed``: ``int`` or
    ``torch.Generator``.  ``resume_state`` continues a previous state for
    ``num_iterations`` more steps; the Philox counter carries the absolute
    step, so the continuation draws what an uninterrupted run would have.
    ``draws`` (CPU only, for tests) replaces the Philox stream."""
    dev = resolve_device(device)
    if proposal is None and base_variance is None:
        raise ValueError("pass either base_variance or a proposal")
    if proposal is not None and proposal.name != "Normal":
        raise NotImplementedError(
            f"fused RWM takes the Normal proposal only; {proposal.name} "
            "waits for ROADMAP Queue B item 6/7")
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
    base = (base_variance if proposal is None
            else proposal.base_variance_scalar)
    beta_t = torch.tensor(float(beta), dtype=f32, device=dev)
    sigma = torch.sqrt(torch.as_tensor(base, dtype=f32).to(dev) / beta_t)
    key = seed_key(seed)
    args = (target, x0, acc0, jump0, beta_t, sigma, key, step0, total,
            burn_in)
    if dev.type == "cpu":
        x, lp, acc, jump = _run_rwm_fused_plain(*args, draws=draws)
    else:
        x, lp, acc, jump = launch_rwm_kernel(*args)
    n = max(step0 + total - burn_in, 1)
    state = RWMState(x=x, logp=lp, accept_count=acc, sum_sq_jump=jump,
                     step=step0 + total)
    return RWMResult(state=state, acceptance_rate=acc / n, esjd=jump / n,
                     chain=None)
