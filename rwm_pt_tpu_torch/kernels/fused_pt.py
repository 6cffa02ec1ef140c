"""Fused whole-run Parallel Tempering: the CUDA kernels ``csrc/fused_pt.cu``
(one thread a (replica, rung), d <= 64) and ``csrc/fused_pt_warp.cu`` (a
team of G lanes a (replica, rung), 64 < d <= 4092) and their plain PyTorch
version (port of ``rwm_pt_tpu.kernels.pallas_pt.run_pt_pallas`` with its
cold-chain recording variant, the Normal, Laplace and UniformRadius
proposals, every normal draw of ``draws.NORMAL_IMPLS``, every target kind
of ``_build.kernel_target``).

``run_pt_fused`` does the wrapper's bookkeeping (per-rung scales, seeding,
resume, initial states, analytic swap attempts, post-burn-in normalization)
and hands the step loop to :func:`launch_pt_kernel` for CUDA tensors or to
:func:`_run_pt_fused_plain` for CPU tensors.  Both consume the Philox
stream of :mod:`.draws`, so on the card they follow one trajectory up to
f32 rounding.  There is no fallback: a CUDA run launches the kernel or
raises.

The swap sweep runs its pairs in one of two orders (``swap_sweep``):
``"sequential"``, j = 0..T-2, the Pallas kernel's sweep; or
``"even_odd"``, the even pairs 0, 2, 4.. then the odd pairs 1, 3, 5..,
which equals the JAX scan engine's two half-sweeps (pairs of one parity
are disjoint).  Each pair draws its uniform from rung j's Philox slot d+1
in either order.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from ..utils.dtypes import as_tensor, resolve_device
from . import _build
from .draws import (increment, n_records, resolve_normal_impl,
                    resolve_seed, seed_key, step_draws)
from .pt import PTResult, PTState
from .rwm import step_generator


SWEEPS = ("sequential", "even_odd")


def pair_order(T: int, swap_sweep: str = "sequential") -> list:
    """The pairs (j, j+1) of a swap sweep, in the order they are tried."""
    if swap_sweep == "sequential":
        return list(range(T - 1))
    if swap_sweep == "even_odd":
        return list(range(0, T - 1, 2)) + list(range(1, T - 1, 2))
    raise ValueError("swap_sweep must be 'sequential' or 'even_odd'")


def _run_pt_fused_plain(target, x0, acc0, swapacc0, betajump0, coldjump0,
                        betas, sigmas, key, step0, total, burn_in,
                        swap_every, draws=None, *, kind="Normal",
                        record_every=0, record_chains=0, draw="icdf",
                        swap_sweep="sequential", replica0=0, rung0=0):
    """Plain version of the kernel, step by step with its arithmetic: MH on
    every rung; on post-burn-in multiples of ``swap_every`` the swap sweep
    over the pairs in the order :func:`pair_order`; normals of ``draw``;
    int32 counts; Kahan-compensated beta-jump and
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
    every ``record_every``-th step.  ``replica0`` and ``rung0`` offset the
    Philox counter's replica and rung (a shard of a sharded run,
    ``draws.slot_words``)."""
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
    order = pair_order(T, swap_sweep)
    for s in range(total):
        abs_step = step0 + s + 1
        post = abs_step > burn_in
        do_swap = post and abs_step % swap_every == 0
        if draws is None:
            inc, u_mh, u_sw, u_rad = step_draws(key, abs_step, T, d, C,
                                                x.device, kind=kind,
                                                draw=draw, replica0=replica0,
                                                rung0=rung0)
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
        # ---- swap sweep (compensation steps on every step)
        for j in order:
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
                     *, kind="Normal", record_every=0, record_chains=0,
                     draw="icdf", swap_sweep="sequential", warp=None,
                     team=None, cluster=None, specialize=True, replica0=0,
                     rung0=0, _stamps=False):
    """Launch ``csrc/fused_pt.cu``, or above 64 dimensions
    ``csrc/fused_pt_warp.cu`` (the library built for proposal ``kind``,
    ``draw`` and the target's kind, ``_build.route``: a SuperFunnel whose
    dataset fits takes the build with its shape fixed; ``warp=True`` takes
    the warp kernel at any d, to compare the layouts; ``team`` forces the
    warp kernel's team size G, the lanes a (replica, rung), where
    ``_build.choose_team`` would pick one; ``cluster=k`` forces the warp
    kernel's cluster build, a replica's rung-teams over a cluster of k
    blocks, where the geometry takes it only for a ladder one block does
    not hold; ``specialize=False`` forces SuperFunnel's run-time-shape
    library; ``team``, ``cluster`` and ``specialize`` for comparisons
    only) on the current stream; same
    arguments and results as :func:`_run_pt_fused_plain`.  ``launches``
    counts each launch under ``_build.launch_key`` of its library (the name
    without its register bucket, ``fused_pt.rosenbrock``,
    ``fused_pt_bm.mvn_iso``, ``fused_pt_lax_erfinv.super_funnel.j5k3n20u2b3``,
    .., or a warp library's whole name,
    ``fused_pt_lax_erfinv.mvn_iso.w128``, its cluster build's
    ``fused_pt_lax_erfinv.mvn_iso.c1024``; ``_build.by_variant`` sums them
    by variant), and a recorded one also under ``fused_pt_record``.  The
    replicas a block come from ``_build.launch_geometry`` (the kernel's
    registers and launch bound, the rows' shared memory; a warp library's
    team size and blocks a cluster too).  A ladder of more rungs than
    ``_build.target_rungs_fit`` raises ``NotImplementedError`` naming the
    layout that sets the fit, before anything is built.  ``_stamps``
    launches the cluster build's measuring build, uncounted
    (:func:`swap_split`)."""
    variant = _build.library("fused_pt", kind, draw)
    lib, tkind, params = _build.route(variant, target, warp, specialize)
    if _build.fixed_shape(lib) is None or _build.is_warp(lib):
        # (a fixed thread build's words are a kernel parameter, on the host)
        params = params.to(x0.device)
    d, T, C = x0.shape
    pair_order(T, swap_sweep)                # raises for an unknown order
    order = SWEEPS.index(swap_sweep)
    if target.dim != d:
        raise ValueError(f"x0 has {d} coordinates, the target {target.dim}")
    fit = _build.target_rungs_fit(target, kind)
    if 0 < fit.rungs < T:   # (no rung at all: the geometry names the words)
        raise NotImplementedError(
            f"fused PT takes at most {fit.rungs} rungs at d={d} on {tkind} "
            f"under {kind} ({fit.layout}); T={T}")
    _build.check_cuda("fused_pt", torch.float32, x0=x0, betajump0=betajump0,
                      coldjump0=coldjump0, betas=betas, sigmas=sigmas)
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
    geo = _build.launch_geometry(lib, d, C, T, kind, draw, params.numel(),
                                 team, cluster)
    if geo.cluster:
        lib = _build.cluster_lib(lib, _stamps)
    elif _stamps:
        raise ValueError(f"{lib}: the measuring build is the cluster "
                         f"build's; pass cluster=")
    warp = _build.is_warp(lib)
    rows, claim, pool = (_build.terms_pool(lib, geo, d, T, params.numel(),
                                           x0.device)
                         if warp else (None, None, 0))
    fn = _build.entry(lib)
    rc = fn(_build.TARGET_KINDS[tkind], params.data_ptr(), params.numel(),
            betas.data_ptr(),
            sigmas.data_ptr(), x0.data_ptr(), acc0.data_ptr(),
            swapacc0.data_ptr(), betajump0.data_ptr(), coldjump0.data_ptr(),
            x.data_ptr(), lp.data_ptr(), acc.data_ptr(), swapacc.data_ptr(),
            bj.data_ptr(), cj.data_ptr(), d, T, C, total, burn_in,
            swap_every, step0, key[0], key[1], replica0, rung0,
            sigmas.data_ptr() if kind == "Laplace" else 0, 1.0 / d,
            rec_ptr, record_every or 0, record_chains if n_rec else 0, order,
            geo.replicas,
            *((geo.team, geo.cluster,
               0 if rows is None else rows.data_ptr(),
               0 if claim is None else claim.data_ptr(), pool) if warp
              else (int(geo.runtime_r),)),
            torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check_launch(lib, rc)
    if _stamps:
        return x, lp, acc, swapacc, bj, cj
    launch_pt_kernel.launches[_build.launch_key(lib)] += 1
    if n_rec:
        launch_pt_kernel.launches["fused_pt_record"] += 1
        return x, lp, acc, swapacc, bj, cj, chain
    return x, lp, acc, swapacc, bj, cj


launch_pt_kernel.launches = Counter()

# the parts of a swap step between the cluster build's stamps
# (csrc/fused_pt_warp.cu, -DRWM_PT_STAMPS): the MH move, the first cluster
# barrier, the sweep (or the wait for it), the second barrier, the
# cold-rung jump, the third barrier
SWAP_SPLIT = ("mh", "barrier1", "sweep", "barrier2", "cold", "barrier3")


def swap_split(*args, **kw) -> dict:
    """One launch of the cluster build's measuring build (library
    ``...c<D>s``, uncounted) with :func:`launch_pt_kernel`'s arguments
    (``cluster=`` or a ladder no block holds): the mean µs a swap step of
    each part of :data:`SWAP_SPLIT` as block thread 0 sees it, over the
    blocks and the swap steps, with ``"swap_step"`` their sum,
    ``"step"`` the mean µs of a step with no swap, and the counts
    ``"swap_steps"`` and ``"steps"`` (block-steps).  Needs the card."""
    x0 = args[1]
    variant = _build.library("fused_pt", kw.get("kind", "Normal"),
                             kw.get("draw", "icdf"))
    lib = _build.route(variant, args[0], kw.get("warp"))[0]
    geo = _build.launch_geometry(lib, x0.shape[0], x0.shape[2],
                                 x0.shape[1], kw.get("kind", "Normal"),
                                 kw.get("draw", "icdf"),
                                 _build.kernel_target(args[0])[1].numel(),
                                 kw.get("team"), kw.get("cluster"))
    name = _build.cluster_lib(lib, stamps=True)
    stamps = _build.entry(name, "rwm_pt_fused_pt_stamps")
    words = (ctypes.c_uint64 * 9)()
    _build.check_launch(name, stamps(None, 1))
    launch_pt_kernel(*args, **kw, _stamps=True)
    _build.check_launch(name, stamps(words, 0))
    n_swap, n_step = max(words[6], 1), max(words[7], 1)
    out = {k: words[i] / n_swap / 1e3 for i, k in enumerate(SWAP_SPLIT)}
    out["swap_step"] = sum(out[k] for k in SWAP_SPLIT)
    out["step"] = words[8] / n_step / 1e3
    out["swap_steps"], out["steps"] = int(words[6]), int(words[7])
    out["team"], out["cluster"] = geo.team, geo.cluster
    return out


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
                 swap_sweep: str = "sequential", device="cuda",
                 draws=None, _shard: _build.Shard | None = None) -> PTResult:
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
    the launch's steps raises.  ``swap_sweep``: the pair order of a swap
    event, ``"sequential"`` (the Pallas sweep, the default) or
    ``"even_odd"`` (module docstring).  The normals are drawn by
    ``draws.resolve_normal_impl("pt", num_chains, <the target's kind>)``
    (``draws.NORMAL_IMPL`` forces any of the five draws, each launching its
    own library).
    ``draws`` (CPU only, for tests) replaces the Philox stream.  ``_shard``
    is the counter layout of one shard of ``fused_sharded.py``'s runs, not
    a user option."""
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
    pair_order(T, swap_sweep)                # raises for an unknown order
    shard = _shard or _build.Shard()
    kw = dict(kind=kind, record_every=record_every or 0,
              record_chains=record_chains, swap_sweep=swap_sweep,
              draw=shard.draw or resolve_normal_impl(
                  "pt", x0.shape[2], _build.target_kind(target)),
              replica0=shard.replica0, rung0=shard.rung0)
    if dev.type == "cpu" or shard.plain:
        out = _run_pt_fused_plain(*args, draws=draws, **kw)
    else:
        out = launch_pt_kernel(*args, team=shard.team, **kw)
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
