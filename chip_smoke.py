#!/usr/bin/env python3
"""On-card smoke gate and flagship measurement of the PyTorch/CUDA port.

    python3 chip_smoke.py          # one CUDA card; exits non-zero on failure

Drives ``rwm_pt_tpu_torch`` (never JAX) in phases, one line each:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: both kernels from ``rwm_pt_tpu_torch/kernels/csrc``, one library
   per proposal (six ``nvcc``, all in parallel), with ptxas registers and
   spills per instantiation;
3. kernel vs plain on one Philox stream: PT on FullRosenbrock d=30, T=10,
   C=2048 (200 steps, burn-in 50, swap every 10) and RWM on MVN d=10,
   C=2048: share of replicas whose final x agrees to 1e-3 (rounding can flip
   a rare accept decision, after which that replica diverges), max |diff|
   over them; on them every counter equal and lp and the Kahan sums to
   rtol 1e-4 (``kernels/agreement.py``); counter rates with a z-score;
4. fused PT vs the eager engine ``run_pt(swap_sweep="sequential")`` on MVN
   d=10, T=6, C=1024: swap and per-rung MH acceptance;
5. exact invariance (Geweke) of the fused RWM and PT kernels on MVN d=10,
   C=4096, with a fresh seed that is printed;
6. main paths through the user entry points, launch counters zeroed just
   before and read just after each: the flagship PT run of ``bench.py``
   (30-d FullRosenbrock, 10 rungs 1..0.01, variance 0.5^2/30, swap every
   100, 65,536 replicas, 2000 steps) and the RWM headline run of
   ``scripts/bench_rwm_impl_block.py`` (30-d FullRosenbrock, 65,536 chains,
   2000 steps), each timed through its entry point with CUDA events (best
   of 3).  Each kernel is then timed alone at its main path's size and
   beside its bound, and held against its plain version at the main path's
   shapes over 200 steps, as in phase 3.
7. every new kernel variant against its plain version at main-path shapes
   over 200 steps (phase 3's checks; a recorded trace must agree to 1e-3
   on the agreeing replicas): RWM on 30-d FullRosenbrock at 65,536 chains
   and PT at the flagship shape, each with the Laplace and the
   UniformRadius proposal and with recording (Normal, every step; the held
   run records 1024 replicas and PT swaps every 10 steps in it, so a
   snapshot taken before the swap sweep shows); each is also timed alone
   at its main path's size (recording the first 4 replicas).  The RWM
   Laplace and UniformRadius kernels are also held at the study's shape
   (MVN d=20, 1024 chains) at three scales of its grid;
8. fused vs eager rates (z < 5) and exact invariance (Geweke, max z < 5,
   fresh printed seed) for the Laplace and UniformRadius proposals on MVN
   d=10, RWM and PT;
9. the harness on the card: ``MCMCSimulation`` PT at the flagship shape
   and RWM at 65,536 chains, 2000 iterations, ``record_chain=True``,
   ``record_chains=4``, for each of the three proposals, launch counters
   zeroed just before and read just after each run: one launch of the
   fused kernel per run (and of its recording path), ``engine_used ==
   "pallas"``, a finite ``(2000, 30)`` chain, finite split R-hat and ESS;
10. the RWM proposal study ``experiment_rwm`` at
   ``scripts/launch_rwm_pod.sh``'s shape on MultivariateNormal (dim 20,
   200,000 iterations, burn-in 1000, 1024 chains, var_max 4.0, seed 1,
   ``--no_plots``) for Laplace and UniformRadius, ``STUDY_CONFIGS`` scale
   configs each (the cut from the CLI's 40 is printed): one launch per
   config; the ESJD-optimal acceptance and steps/s.  The study's JSON and
   logs go to ``smoke_out/study/`` beside this script.

The line before the last holds the kernels' JSON record (every variant),
the last line ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks: f32 outside the tensor cores and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
AGREE_MIN = 0.95       # share of replicas whose final x must agree
Z_RATE_MAX = 5.0       # counters' rates, kernel vs plain
Z_INV_MAX = 5.0        # Geweke invariance bound (scripts/tpu_smoke.py)
HOLD_STEPS = 200       # steps of the kernel-vs-plain run at main-path shapes

# bench.py:63-95, the flagship PT workload
FLAG = dict(dim=30, T=10, C=65536, iters=2000, swap_every=100,
            base_variance=0.5 ** 2 / 30)
# scripts/bench_rwm_impl_block.py, the headline RWM workload
RWM_MAIN = dict(dim=30, C=65536, iters=2000, base_variance=0.5 ** 2 / 30)
# scripts/launch_rwm_pod.sh:29-34, the RWM proposal study, on the README's
# MultivariateNormal (its default RoughCarpetScaled is not ported yet)
STUDY = dict(dim=20, iters=200000, burn_in=1000, C=1024, var_max=4.0, seed=1)
STUDY_CONFIGS = 40     # of the CLI's 40 scale configs per proposal
REC_CHAINS = 4         # replicas recorded by the harness runs (phase 9)
REC_HOLD_CHAINS = 1024  # replicas recorded by the held runs (phase 7)
NEW_PROPOSALS = ("Laplace", "UniformRadius")


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=1):
    """Best of ``reps`` CUDA-event timings of ``fn()`` in ms, and its last
    result."""
    best, out = math.inf, None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best, out


# ---------------------------------------------------------------- op counts
# Float operations the fused kernels' function needs, counted from
# csrc/*.cuh (an FMA counts 2; logf, log1pf, sqrtf, expf, a division 1
# each; selects, sign and integer work 0):
#   ICDF normal: cvt+scale 2, 2u-1+2^-24 3, (1-x)(1+x) 3, fmax 1, logf 1,
#     neg 1, then one branch of Giles' polynomial: w-2.5 1 and 8 FMAs 16
#     (the tail branch, w >= 5, takes sqrtf-3 instead of w-2.5, one more
#     op on about 0.3% of draws, left out), x*p 1, sqrt2* 1 = 30;
#     Normal increment and proposal 2  -> 32 per coordinate.  The kernel
#     evaluates both polynomials and selects; the bound counts one.
#   Laplace per coordinate: cvt+scale 2, u-0.5 1, -2|v| 1, fmax 1,
#     log1pf 1, -scale*sign 1, product 1, proposal 1 -> 9.
#   UniformRadius: per coordinate the normal 30, square-accumulate 2,
#     divide by the norm 1, times the radius 1, proposal 1 -> 35; per step
#     sqrtf 1, fmax 1, radius cvt+scale 2, logf 1, *1/d 1, expf 1, *R 1 -> 8.
#   log-density: Rosenbrock 9 per term (d-1 terms) + 1; MVN iso 4 d + 2
#   accept: lp' - lp, *beta, expf, cvt+scale of u, 2 compares -> 7
#   squared jump (cold rung / RWM chain) 3 d + Kahan 4
#   swap pair: 2 subs, mul, expf, compare, Kahan 5 -> 10
# Philox4x32-10 integer work (100 int ops per block of 4 words) is reported
# beside it and left out of the bound: the published table has no int32 rate.
def lp_flops(kind, d):
    return 9 * (d - 1) + 1 if kind == "rosenbrock" else 4 * d + 2


def inc_flops(prop, d):
    return {"Normal": 32 * d, "Laplace": 9 * d,
            "UniformRadius": 35 * d + 8}[prop]


def philox_blocks(prop, d):
    """Philox blocks a (replica, rung) draws per step: slots 0..d
    (UniformRadius: 0..d+2)."""
    return -(-(d + (3 if prop == "UniformRadius" else 1)) // 4)


def rec_bytes(d, steps, record_every, rec_chains):
    return (steps // record_every) * d * rec_chains * 4 if record_every else 0


def pt_work(kind, d, T, C, steps, burn_in, swap_every, step0=0,
            prop="Normal", record_every=0, rec_chains=0):
    n_events = (step0 + steps) // swap_every - max(burn_in, step0) // swap_every
    mh = (inc_flops(prop, d) + lp_flops(kind, d) + 7) * T
    flops = C * (steps * (mh + 3 * d + 4) + n_events * 10 * (T - 1)
                 + T * lp_flops(kind, d))
    blocks = C * T * steps * philox_blocks(prop, d)
    int_ops = 100 * blocks
    nbytes = (C * (2 * d * T * 4 + T * 4 + 2 * T * 4 + 6 * 4)
              + (T * d * 4 if prop == "Laplace" else 0)
              + rec_bytes(d, steps, record_every, rec_chains))
    return flops, int_ops, nbytes


def rwm_work(kind, d, C, steps, prop="Normal", record_every=0, rec_chains=0):
    flops = C * (steps * (inc_flops(prop, d) + lp_flops(kind, d) + 7
                          + 3 * d + 4) + lp_flops(kind, d))
    int_ops = 100 * C * steps * philox_blocks(prop, d)
    nbytes = (C * (2 * d * 4 + 4 + 2 * 4 + 2 * 4)
              + (d * 4 if prop == "Laplace" else 0)
              + rec_bytes(d, steps, record_every, rec_chains))
    return flops, int_ops, nbytes


def bound(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rate_z(a, b, n):
    """z of two acceptance proportions over n trials each."""
    p = 0.5 * (a + b)
    se = math.sqrt(max(p * (1 - p), 1e-12) * 2 / n)
    return abs(a - b) / se


def hold_run(torch, what, launch, plain, args, kw, names):
    """Time ``launch(*args, **kw)`` (best of 3) and its plain version (once)
    and hold the two together with phase 3's checks; a disagreement fails
    the smoke.  Returns ``(kernel ms, plain ms, agreement)``."""
    from rwm_pt_tpu_torch.kernels import agreement
    ms, k = cuda_ms(torch, lambda: launch(*args, **kw), reps=3)
    plain_ms, p = cuda_ms(torch, lambda: plain(*args, **kw))
    ag = agreement.hold(k, p, names)
    if ag.frac < AGREE_MIN or ag.mismatched:
        fail(f"{what} disagrees with its plain version: "
             f"{agreement.describe(ag)}")
    return ms, plain_ms, ag


def kernel_record(torch, name, source, replaces, launches, launch, plain,
                  names, case, iters, phase=6):
    """Time kernel ``name`` alone at its main path's size (``iters`` steps,
    best of 3), then over HOLD_STEPS steps at the main path's shapes time
    it again, time its plain version once, hold the two together
    (:func:`hold_run`) and set both kernel times beside their bounds.
    ``case(steps, hold)`` gives a launch's ``(args, kw, work)``, ``work``
    being ``(flops, Philox int ops, bytes)``; the held run (``hold=True``)
    may record more replicas or swap more often than the main path, so
    that the hold sees more.  ``ms``, ``plain_ms`` and ``bound_ms`` of the
    record are for the HOLD_STEPS run, the ``main_path_*`` keys for the
    main path's size."""
    from rwm_pt_tpu_torch.kernels import agreement
    full_args, full_kw, full_work = case(iters, False)
    full_ms, _ = cuda_ms(torch, lambda: launch(*full_args, **full_kw),
                         reps=3)
    del full_args, _
    hold_args, hold_kw, (flops, int_ops, nbytes) = case(HOLD_STEPS, True)
    ms, plain_ms, ag = hold_run(torch, f"{name} at main-path shapes", launch,
                                plain, hold_args, hold_kw, names)
    b_ms, b_by = bound(flops, nbytes)
    full_flops, full_int, full_bytes = full_work
    full_b_ms, full_by = bound(full_flops, full_bytes)
    say(f"phase {phase} {name} kernel: {full_ms:.3f} ms at its main path's "
        f"size, bound {full_b_ms:.3f} ms by {full_by} ({full_flops:.4g} "
        f"flops, {full_int:.4g} Philox int ops, {full_bytes:.4g} B); "
        f"{HOLD_STEPS} steps at main-path shapes: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms ({plain_ms / HOLD_STEPS:.3f} ms/step), bound "
        f"{b_ms:.3f} ms; {agreement.describe(ag)}")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=ag.max_dx, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, steps=HOLD_STEPS,
        agree_frac=ag.frac, max_rel_err=ag.max_rel, flops=flops,
        philox_int_ops=int_ops, bytes=nbytes, main_path_steps=iters,
        main_path_ms=full_ms, main_path_bound_ms=full_b_ms)


def reset_launches(*wrappers):
    for w in wrappers:
        w.launches.clear()


def read_launches(*wrappers):
    out = Counter()
    for w in wrappers:
        out.update(w.launches)
    return out


def per_chain_z(a, b):
    """z of the difference of the means of two per-replica rate tensors
    (replicas independent)."""
    a, b = a.double().flatten(), b.double().flatten()
    se = math.sqrt(a.var().item() / a.numel() + b.var().item() / b.numel())
    return abs(a.mean().item() - b.mean().item()) / (se + 1e-12)


def invariance(torch, mvn, seed, n=4096, **sampler_kw):
    """Exact invariance (Geweke) of the fused samplers on ``mvn`` with a
    generator seeded ``seed``: RWM starts 4096 chains from exact draws and
    runs 50 steps, PT starts 4096 replicas from exact tempered draws on 6
    rungs (1 .. 0.09) and runs 60 steps with a swap every 5; each ensemble
    is held against fresh exact draws (max z over the coordinates' first
    and second moments and the mean log-density).  ``sampler_kw`` is the
    proposal (``base_variance=`` or ``proposal=``).  Returns
    ``(max z RWM, max z PT over the rungs, PT swap acceptance)``."""
    from rwm_pt_tpu_torch.kernels import run_pt_fused, run_rwm_fused
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def max_z(ev, fresh):
        def stats(x):
            f = torch.cat([x, x * x, mvn.log_density_td(x)[None]], dim=0)
            return f.mean(1), f.var(1, unbiased=False)
        m1, v1 = stats(ev)
        m2, v2 = stats(fresh)
        return ((m1 - m2).abs() / torch.sqrt((v1 + v2) / n + 1e-12)) \
            .max().item()

    exact = mvn.direct_sample(n, 1.0, g).T
    r = run_rwm_fused(mvn, seed, num_chains=n, num_iterations=50,
                      init_states=exact, device=dev, **sampler_kw)
    z_rwm = max_z(r.state.x, mvn.direct_sample(n, 1.0, g).T)
    bi = torch.logspace(0, math.log10(0.09), 6, device=dev)
    cube = torch.stack([mvn.direct_sample(n, b.item(), g).T for b in bi],
                       dim=1)
    r = run_pt_fused(mvn, seed + 1, bi, num_chains=n, num_iterations=60,
                     swap_every=5, init_states=cube, device=dev,
                     **sampler_kw)
    z_pt = max(max_z(r.state.x[:, t], mvn.direct_sample(n, b.item(), g).T)
               for t, b in enumerate(bi))
    return z_rwm, z_pt, r.swap_acceptance_rate.mean().item()


def proposal_params(prop, dim, var):
    """Parameters of proposal ``prop`` matched to a Normal proposal of
    variance ``var``: the same variance per coordinate for Laplace, and for
    UniformRadius a radius of sqrt(dim * var), the Normal increment's RMS
    length."""
    return {"Normal": {"base_variance_scalar": var},
            "Laplace": {"base_variance_vector": var},
            "UniformRadius": {"base_radius": math.sqrt(dim * var)}}[prop]


def phases_7_to_10(torch, gen):
    """Phases 7-10: the Laplace, UniformRadius and recording variants of
    both kernels held against their plain versions (7), against the eager
    engines and for invariance (8), the harness (9) and the study (10).
    Returns the kernels' JSON records of the new variants, with their
    launches on the harness and study runs."""
    import contextlib

    import numpy as np

    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli import experiment_rwm
    from rwm_pt_tpu_torch.cli.common import build_proposal_config
    from rwm_pt_tpu_torch.kernels import (_build, agreement, fused_pt,
                                          fused_rwm, run_pt, run_pt_fused,
                                          run_rwm, run_rwm_fused)
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.proposals import create_proposal_distribution
    from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal

    dev = torch.device("cuda")
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    d, T, C, Cr = FLAG["dim"], FLAG["T"], FLAG["C"], RWM_MAIN["C"]
    var = FLAG["base_variance"]
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    beta1 = torch.tensor(1.0, device=dev)

    def proposal(prop, dim, v):
        return create_proposal_distribution(
            dim, {"name": prop, "params": proposal_params(prop, dim, v)},
            device=dev)

    # ---- 7. every new variant against its plain version
    variants = [  # (record name, sampler, proposal, recording, replaces)
        ("fused_rwm_laplace", "RWM", "Laplace", False,
         "rwm_pt_tpu/kernels/pallas_rwm.py:204"),
        ("fused_rwm_uniform_radius", "RWM", "UniformRadius", False,
         "rwm_pt_tpu/kernels/pallas_rwm.py:213"),
        ("fused_rwm_record", "RWM", "Normal", True,
         "rwm_pt_tpu/kernels/pallas_rwm.py:552"),
        ("fused_pt_laplace", "PT", "Laplace", False,
         "rwm_pt_tpu/kernels/pallas_pt.py:314"),
        ("fused_pt_uniform_radius", "PT", "UniformRadius", False,
         "rwm_pt_tpu/kernels/pallas_pt.py:311"),
        ("fused_pt_record", "PT", "Normal", True,
         "rwm_pt_tpu/kernels/pallas_pt.py:377"),
    ]
    records = {}
    for name, algo, prop, rec, replaces in variants:
        if algo == "PT":
            kind, sig = fused_pt.rung_scales(proposal(prop, d, var), None,
                                             betas, torch.ones_like(betas))

            def case(steps, hold, sig=sig, prop=prop, rec=rec, kind=kind):
                # the held recorded run swaps every 10 steps and records
                # REC_HOLD_CHAINS replicas, so that a snapshot taken before
                # the swap sweep cannot go unseen
                swap_every = 10 if hold and rec else FLAG["swap_every"]
                n_rec = (REC_HOLD_CHAINS if hold else REC_CHAINS) if rec else 0
                x0 = (1e-8 * torch.randn(d, 1, C, generator=gen,
                                         device=dev)).expand(d, T, C)
                args = (rb, x0.contiguous(), zi(T, C), zi(C), zf(C), zf(C),
                        betas, sig, seed_key(0), 0, steps, 0, swap_every)
                kw = dict(kind=kind, record_every=int(rec),
                          record_chains=n_rec)
                return args, kw, pt_work(
                    "rosenbrock", d, T, C, steps, 0, swap_every, prop=prop,
                    record_every=int(rec), rec_chains=n_rec)
            launch, plain = (fused_pt.launch_pt_kernel,
                             fused_pt._run_pt_fused_plain)
            names = agreement.PT_REC_OUTPUTS if rec else agreement.PT_OUTPUTS
            source = "rwm_pt_tpu_torch/kernels/csrc/fused_pt.cu"
        else:
            kind, scale = fused_rwm.proposal_scale(proposal(prop, d, var),
                                                   None, beta1)

            def case(steps, hold, scale=scale, prop=prop, rec=rec,
                     kind=kind):
                n_rec = (REC_HOLD_CHAINS if hold else REC_CHAINS) if rec else 0
                x0 = 1e-8 * torch.randn(d, Cr, generator=gen, device=dev)
                args = (rb, x0, zi(Cr), zf(Cr), beta1, scale, seed_key(0), 0,
                        steps, 0)
                kw = dict(kind=kind, record_every=int(rec),
                          record_chains=n_rec)
                return args, kw, rwm_work(
                    "rosenbrock", d, Cr, steps, prop=prop,
                    record_every=int(rec), rec_chains=n_rec)
            launch, plain = (fused_rwm.launch_rwm_kernel,
                             fused_rwm._run_rwm_fused_plain)
            names = (agreement.RWM_REC_OUTPUTS if rec
                     else agreement.RWM_OUTPUTS)
            source = "rwm_pt_tpu_torch/kernels/csrc/fused_rwm.cu"
        records[name] = kernel_record(
            torch, name, source, replaces, 0, launch, plain, names, case,
            FLAG["iters"], phase=7)
        torch.cuda.empty_cache()

    # The study's instantiations (MVN iso, DMAX 32) at its shape: d=20,
    # 1024 chains, HOLD_STEPS steps (burn-in 50), at the first, the 25th
    # and the last scale of its 40-point grid.
    mvn_s = MultivariateNormal.create(STUDY["dim"], device=dev)
    Ds, Cs = STUDY["dim"], STUDY["C"]
    grid = np.linspace(0.01, STUDY["var_max"], 40)
    for name, prop in (("fused_rwm_laplace", "Laplace"),
                       ("fused_rwm_uniform_radius", "UniformRadius")):
        holds = []
        for i in (0, 24, 39):
            p = create_proposal_distribution(
                Ds, build_proposal_config(prop, float(grid[i]), Ds),
                device=dev)
            kind, scale = fused_rwm.proposal_scale(p, None, beta1)
            x0 = torch.randn(Ds, Cs, generator=gen, device=dev)
            args = (mvn_s, x0, zi(Cs), zf(Cs), beta1, scale, seed_key(i), 0,
                    HOLD_STEPS, 50)
            ms, plain_ms, ag = hold_run(
                torch, f"{name} at the study's shape, scale {grid[i]:.4f}",
                fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
                args, dict(kind=kind), agreement.RWM_OUTPUTS)
            b_ms, _ = bound(*rwm_work("mvn_iso", Ds, Cs, HOLD_STEPS,
                                      prop=prop)[::2])
            holds.append(dict(scale=float(grid[i]), ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, agree_frac=ag.frac,
                              max_abs_err=ag.max_dx, max_rel_err=ag.max_rel))
            say(f"phase 7 {name} at the study's shape (MVN d={Ds}, {Cs} "
                f"chains, scale {grid[i]:.4f} of the grid, {HOLD_STEPS} "
                f"steps, burn-in 50): kernel {ms:.3f} ms, plain "
                f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms; "
                f"{agreement.describe(ag)}")
        records[name]["study_shape_holds"] = holds
        records[name]["max_abs_err"] = max(
            [records[name]["max_abs_err"]] + [h["max_abs_err"] for h in holds])

    # ---- 8. fused vs eager rates and invariance, new proposals, MVN d=10
    d2, bv = 10, 2.38 ** 2 / 10
    mvn = MultivariateNormal.create(d2, device=dev)
    betas6 = torch.logspace(0, -2, 6, device=dev)
    seed = int.from_bytes(os.urandom(4), "little")
    run_kw = dict(num_chains=1024, num_iterations=2000, burn_in=200,
                  device=dev)
    for prop in NEW_PROPOSALS:
        p = proposal(prop, d2, bv)
        fr = run_rwm_fused(mvn, 31, proposal=p, **run_kw)
        er = run_rwm(mvn, p, 32, **run_kw)
        z_rwm = max(per_chain_z(fr.acceptance_rate, er.acceptance_rate),
                    per_chain_z(fr.esjd, er.esjd))
        fp = run_pt_fused(mvn, 33, betas6, proposal=p, swap_every=20,
                          **run_kw)
        ep = run_pt(mvn, p, 34, betas6, swap_every=20,
                    swap_sweep="sequential", **run_kw)
        z_pt = max([per_chain_z(fp.acceptance_rate[t], ep.acceptance_rate[t])
                    for t in range(6)]
                   + [per_chain_z(fp.swap_acceptance_rate,
                                  ep.swap_acceptance_rate)])
        zi_rwm, zi_pt, sw = invariance(torch, mvn, seed, proposal=p)
        say(f"phase 8 {prop}: fused vs eager RWM acc "
            f"{fr.acceptance_rate.mean().item():.4f} vs "
            f"{er.acceptance_rate.mean().item():.4f}, ESJD "
            f"{fr.esjd.mean().item():.4f} vs {er.esjd.mean().item():.4f} "
            f"(max z {z_rwm:.2f}); PT swap acc "
            f"{fp.swap_acceptance_rate.mean().item():.4f} vs "
            f"{ep.swap_acceptance_rate.mean().item():.4f}, max z over "
            f"swap and 6 rungs' MH acc {z_pt:.2f} (< {Z_RATE_MAX}); "
            f"invariance (seed {seed}) max z RWM {zi_rwm:.2f}, PT "
            f"{zi_pt:.2f} (< {Z_INV_MAX}), PT swap acc {sw:.3f}")
        if max(z_rwm, z_pt) >= Z_RATE_MAX:
            fail(f"fused and eager samplers disagree for {prop}")
        if max(zi_rwm, zi_pt) >= Z_INV_MAX or sw <= 0.02:
            fail(f"invariance check failed for {prop}")

    # ---- 9. the harness on the card, recorded, one launch per run
    seen_main = Counter()
    for algo in ("PT", "RWM"):
        for prop in ("Normal",) + NEW_PROPOSALS:
            n_chains = C if algo == "PT" else Cr
            sim = MCMCSimulation(
                dim=d, proposal_config={
                    "name": prop, "params": proposal_params(prop, d, var)},
                num_iterations=FLAG["iters"], algorithm=algo,
                target_dist="FullRosenbrock", seed=0,
                beta_ladder=(betas.tolist() if algo == "PT" else None),
                num_chains=n_chains, swap_every=FLAG["swap_every"],
                record_chain=True, record_chains=REC_CHAINS, device=dev)
            reset_launches(*wrappers)
            chain = sim.generate_samples(verbose=False)
            seen = read_launches(*wrappers)
            src = "fused_pt" if algo == "PT" else "fused_rwm"
            want = {_build.library(src, prop): 1, src + "_record": 1}
            if dict(seen) != want:
                fail(f"harness {algo} {prop} launches {dict(seen)}, "
                     f"want {want}")
            seen_main.update(seen)
            if sim.engine_used != "pallas":
                fail(f"harness {algo} {prop} ran on {sim.engine_used}")
            if (chain is None or chain.shape != (FLAG["iters"], d)
                    or not torch.isfinite(torch.as_tensor(chain)).all()):
                fail(f"harness {algo} {prop} chain is not a finite "
                     f"({FLAG['iters']}, {d}) array")
            rhat, ess = sim.split_rhat(), sim.effective_sample_size()
            if not (math.isfinite(float(rhat.max()))
                    and math.isfinite(float(ess.min()))):
                fail(f"harness {algo} {prop} diagnostics are not finite")
            steps = FLAG["iters"] * n_chains * (T if algo == "PT" else 1)
            say(f"phase 9 harness {algo} {prop}: {steps / sim.elapsed_time:.6g}"
                f" MH steps/s ({sim.elapsed_time * 1e3:.3f} ms wall, "
                f"{n_chains} {'replicas' if algo == 'PT' else 'chains'}, "
                f"recorded {REC_CHAINS}); engine {sim.engine_used}; "
                f"launches {dict(seen)}; acc {sim.acceptance_rate():.4f}, "
                f"ESJD {sim.expected_squared_jump_distance():.5g}; split "
                f"R-hat max {float(rhat.max()):.4f}, ESS min "
                f"{float(ess.min()):.1f}")
            del sim, chain
            torch.cuda.empty_cache()

    # ---- 10. the RWM proposal study at launch_rwm_pod.sh's shape
    out_dir = os.path.join(HERE, "smoke_out", "study")
    os.makedirs(out_dir, exist_ok=True)
    study = {}
    for prop in NEW_PROPOSALS:
        argv = ["--dim", str(STUDY["dim"]), "--target", "MultivariateNormal",
                "--proposal", prop, "--num_iters", str(STUDY["iters"]),
                "--burn_in", str(STUDY["burn_in"]), "--num_chains",
                str(STUDY["C"]), "--var_max", str(STUDY["var_max"]),
                "--seed", str(STUDY["seed"]), "--num_configs",
                str(STUDY_CONFIGS), "--no_plots", "--output_dir", out_dir]
        reset_launches(*wrappers)
        with open(os.path.join(out_dir, f"{prop}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            data = experiment_rwm.main(argv)
        seen = read_launches(*wrappers)
        lib = _build.library("fused_rwm", prop)
        want = {lib: STUDY_CONFIGS}
        if dict(seen) != want:
            fail(f"study {prop} launches {dict(seen)}, want {want}")
        seen_main.update(seen)
        acc, esjd = data["acceptance_rates"], data["expected_squared_jump_"
                                                   "distances"]
        if (len(acc) != STUDY_CONFIGS or not all(0 < a <= 1 for a in acc)
                or not all(e > 0 and math.isfinite(e) for e in esjd)):
            fail(f"study {prop} results out of range")
        study[lib] = data
        say(f"phase 10 study {prop}: MVN d={STUDY['dim']}, "
            f"{STUDY['iters']} iterations + {STUDY['burn_in']} burn-in, "
            f"{STUDY['C']} chains, {STUDY_CONFIGS} of the CLI's 40 scale "
            f"configs (var_max {STUDY['var_max']}): ESJD-optimal acceptance "
            f"{data['max_acceptance_rate']:.4f} at scale "
            f"{data['max_scale_param']:.4f} (ESJD {data['max_esjd']:.5g}); "
            f"{data['mh_steps_per_sec']:.6g} steps/s, "
            f"{data['total_time']:.2f} s in all, "
            f"{1e3 * min(data['times']):.3f}-{1e3 * max(data['times']):.3f}"
            f" ms a config; launches {dict(seen)}")

    out = []
    for name, _, _, _, _ in variants:
        r = records[name]
        r["launches"] = seen_main[name]
        if r["launches"] < 1:
            fail(f"{name} was not launched on the harness or study runs")
        if name in study:
            r["study_ms_per_config"] = 1e3 * min(study[name]["times"])
        out.append(r)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from rwm_pt_tpu_torch.api import MCMCSimulation  # noqa: F401
        from rwm_pt_tpu_torch.kernels import (_build, agreement, fused_pt,
                                              fused_rwm, run_pt, run_pt_fused,
                                              run_rwm, run_rwm_fused)
        from rwm_pt_tpu_torch.kernels.draws import seed_key
        from rwm_pt_tpu_torch.proposals import NormalProposal
        from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal
    except ImportError as e:
        fail(f"the port is not importable next to chip_smoke.py: {e}")
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "rwm_pt_tpu")]
    if bad:
        fail(f"JAX modules loaded: {bad[:5]}")
    t_start = time.time()
    dev = torch.device("cuda")

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    say(f"phase 1 device: {name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi name, power.limit:")
    say(card)

    # ---- 2. build
    t0 = time.time()
    logs = _build.build()
    for kname, log in logs.items():
        regs = []
        func = None
        for line in log.splitlines():
            m = re.search(r"entry function '([^']+)'", line)
            if m:
                t = re.search(r"kernelILi(\d)ELi(\d+)E", m.group(1))
                func = (("rosenbrock" if t.group(1) == "0" else "mvn_iso")
                        + f"/D{t.group(2)}") if t else m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and func:
                regs.append([func, None, int(m.group(1)) + int(m.group(2))])
            m = re.search(r"Used (\d+) registers", line)
            if m and regs and regs[-1][1] is None:
                regs[-1][1] = int(m.group(1))
        desc = ", ".join(f"{f} {r} regs {s} B spill" for f, r, s in regs)
        say(f"phase 2 build {kname}: {desc}")
    say(f"phase 2 build: {len(logs)} libraries (both kernels x 3 "
        f"proposals) in {time.time() - t0:.1f} s")

    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 3. kernel vs plain on one stream
    d, T, C = 30, 10, 2048
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    sig = torch.sqrt(torch.tensor(FLAG["base_variance"], device=dev) / betas)
    x0 = (0.5 * torch.randn(d, 1, C, generator=gen, device=dev)).expand(
        d, T, C).contiguous()
    args = (rb, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig, seed_key(11),
            0, 200, 50, 10)
    k = fused_pt.launch_pt_kernel(*args)
    p = fused_pt._run_pt_fused_plain(*args)
    torch.cuda.synchronize()
    ag = agreement.hold(k, p, agreement.PT_OUTPUTS)
    n_mh, n_sw = 150 * T * C, 15 * (T - 1) * C
    z_mh = rate_z(k[2].sum().item() / n_mh, p[2].sum().item() / n_mh, n_mh)
    z_sw = rate_z(k[3].sum().item() / n_sw, p[3].sum().item() / n_sw, n_sw)
    say(f"phase 3 PT kernel vs plain: {agreement.describe(ag)}; MH acc "
        f"{k[2].sum().item() / n_mh:.5f} vs {p[2].sum().item() / n_mh:.5f} "
        f"(z {z_mh:.2f}); swap acc {k[3].sum().item() / n_sw:.5f} vs "
        f"{p[3].sum().item() / n_sw:.5f} (z {z_sw:.2f})")
    if ag.frac < AGREE_MIN or ag.mismatched or max(z_mh, z_sw) >= Z_RATE_MAX:
        fail("PT kernel disagrees with its plain version")
    d2 = 10
    mvn = MultivariateNormal.create(d2, device=dev)
    x0 = torch.randn(d2, C, generator=gen, device=dev)
    args = (mvn, x0, zi(C), zf(C), torch.tensor(1.0, device=dev),
            torch.sqrt(torch.tensor(2.38 ** 2 / d2, device=dev)),
            seed_key(12), 0, 200, 20)
    k = fused_rwm.launch_rwm_kernel(*args)
    p = fused_rwm._run_rwm_fused_plain(*args)
    torch.cuda.synchronize()
    ag = agreement.hold(k, p, agreement.RWM_OUTPUTS)
    n_r = 180 * C
    z_r = rate_z(k[2].sum().item() / n_r, p[2].sum().item() / n_r, n_r)
    say(f"phase 3 RWM kernel vs plain: {agreement.describe(ag)}; acc "
        f"{k[2].sum().item() / n_r:.5f} vs {p[2].sum().item() / n_r:.5f} "
        f"(z {z_r:.2f})")
    if ag.frac < AGREE_MIN or ag.mismatched or z_r >= Z_RATE_MAX:
        fail("RWM kernel disagrees with its plain version")

    # ---- 4. fused PT vs the eager engine (sequential sweep)
    bv = 2.38 ** 2 / d2
    betas6 = torch.logspace(0, -2, 6, device=dev)
    kw = dict(num_chains=1024, num_iterations=2000, burn_in=200,
              swap_every=20, device=dev)
    fz = run_pt_fused(mvn, 21, betas6, base_variance=bv, **kw)
    ez = run_pt(mvn, NormalProposal.create(d2, bv, device=dev), 22, betas6,
                swap_sweep="sequential", **kw)
    d_swap = abs(fz.swap_acceptance_rate.mean().item()
                 - ez.swap_acceptance_rate.mean().item())
    d_rung = (fz.acceptance_rate.mean(1) - ez.acceptance_rate.mean(1)).abs() \
        .max().item()
    say(f"phase 4 fused PT vs eager: swap acc "
        f"{fz.swap_acceptance_rate.mean().item():.4f} vs "
        f"{ez.swap_acceptance_rate.mean().item():.4f} (|d| {d_swap:.4f} < "
        f"0.05), max per-rung MH |d| {d_rung:.4f} (< 0.03)")
    if d_swap >= 0.05 or d_rung >= 0.03:
        fail("fused PT and the eager engine disagree")

    # ---- 5. exact invariance, fresh seed
    seed = int.from_bytes(os.urandom(4), "little")
    z_rwm, z_pt, sw = invariance(torch, mvn, seed, base_variance=bv)
    say(f"phase 5 invariance (seed {seed}): max z RWM {z_rwm:.2f}, PT "
        f"{z_pt:.2f} over 6 rungs (< {Z_INV_MAX}); PT swap acc {sw:.3f}")
    if max(z_rwm, z_pt) >= Z_INV_MAX or sw <= 0.02:
        fail("invariance check failed")

    # ---- 6. main paths through the entry points, then kernel vs plain
    kernels = []
    d, T, C = FLAG["dim"], FLAG["T"], FLAG["C"]
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    wrappers = (fused_pt.launch_pt_kernel, fused_rwm.launch_rwm_kernel)
    reset_launches(*wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pt_fused(rb, 0, betas, base_variance=FLAG["base_variance"],
                       num_chains=C, num_iterations=FLAG["iters"],
                       swap_every=FLAG["swap_every"], device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    seen = read_launches(*wrappers)
    pt_launches = seen["fused_pt"]
    if pt_launches < 1 or set(seen) != {"fused_pt"}:
        fail(f"flagship path launches: {dict(seen)}")
    st = res.state
    if (tuple(st.x.shape) != (d, T, C) or not torch.isfinite(st.x).all()
            or not torch.isfinite(st.logp).all()):
        fail("flagship state is not finite or has the wrong shape")
    swap_acc = res.swap_acceptance_rate.mean().item()
    cold = res.cold_esjd.mean().item()
    rung_acc = res.acceptance_rate.mean(1).tolist()
    if not (0.05 < swap_acc < 0.95 and cold > 0 and 0 < rung_acc[0] < 1):
        fail(f"flagship metrics out of range: swap {swap_acc}, cold {cold}")
    e2e_ms = [cuda_ms(torch, lambda: run_pt_fused(
        rb, rep, betas, base_variance=FLAG["base_variance"], num_chains=C,
        num_iterations=FLAG["iters"], swap_every=FLAG["swap_every"],
        device=dev))[0] for rep in (1, 2, 3)]
    mh_steps = FLAG["iters"] * T * C
    say(f"phase 6 flagship PT: {mh_steps / (min(e2e_ms) / 1e3):.6g} MH "
        f"steps/s (best of 3: {[round(t, 3) for t in e2e_ms]} ms; first call "
        f"{first_s:.3f} s incl. build load); swap acc {swap_acc:.4f}, cold "
        f"ESJD {cold:.5g}, per-rung MH acc "
        f"{[round(a, 4) for a in rung_acc]}; launches fused_pt {pt_launches} "
        f"fused_rwm 0; card {card}")

    def pt_args(steps):
        x0 = (1e-8 * torch.randn(d, 1, C, generator=gen, device=dev)).expand(
            d, T, C).contiguous()
        sig = torch.sqrt(torch.tensor(FLAG["base_variance"], device=dev)
                         / betas)
        return (rb, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                seed_key(0), 0, steps, 0, FLAG["swap_every"])

    kernels.append(kernel_record(
        torch, "fused_pt", "rwm_pt_tpu_torch/kernels/csrc/fused_pt.cu",
        "rwm_pt_tpu/kernels/pallas_pt.py:399", pt_launches,
        fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
        agreement.PT_OUTPUTS,
        lambda steps, hold: (pt_args(steps), {}, pt_work(
            "rosenbrock", d, T, C, steps, 0, FLAG["swap_every"])),
        FLAG["iters"]))
    del res, st

    # RWM main path: the headline RWM workload
    Cr = RWM_MAIN["C"]
    rwm_kw = dict(base_variance=RWM_MAIN["base_variance"], num_chains=Cr,
                  num_iterations=RWM_MAIN["iters"], device=dev)
    reset_launches(*wrappers)
    rr = run_rwm_fused(rb, 0, **rwm_kw)
    torch.cuda.synchronize()
    seen = read_launches(*wrappers)
    rwm_launches = seen["fused_rwm"]
    if rwm_launches < 1 or set(seen) != {"fused_rwm"}:
        fail(f"RWM path launches: {dict(seen)}")
    if not torch.isfinite(rr.state.x).all():
        fail("RWM main-path state is not finite")
    acc_r = rr.acceptance_rate.mean().item()
    esjd_r = rr.esjd.mean().item()
    if not (0 < acc_r < 1 and esjd_r > 0):
        fail(f"RWM metrics out of range: acc {acc_r}, esjd {esjd_r}")
    e2e_r = [cuda_ms(torch, lambda: run_rwm_fused(rb, rep, **rwm_kw))[0]
             for rep in (1, 2, 3)]
    say(f"phase 6 RWM path: {RWM_MAIN['iters'] * Cr / (min(e2e_r) / 1e3):.6g}"
        f" MH steps/s (best of 3: {[round(t, 3) for t in e2e_r]} ms); acc "
        f"{acc_r:.4f}, ESJD {esjd_r:.5g}; launches fused_rwm {rwm_launches} "
        f"fused_pt 0")

    def rwm_args(steps):
        x0 = 1e-8 * torch.randn(d, Cr, generator=gen, device=dev)
        return (rb, x0, zi(Cr), zf(Cr), torch.tensor(1.0, device=dev),
                torch.sqrt(torch.tensor(RWM_MAIN["base_variance"],
                                        device=dev)),
                seed_key(0), 0, steps, 0)

    kernels.append(kernel_record(
        torch, "fused_rwm", "rwm_pt_tpu_torch/kernels/csrc/fused_rwm.cu",
        "rwm_pt_tpu/kernels/pallas_rwm.py:570", rwm_launches,
        fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
        agreement.RWM_OUTPUTS,
        lambda steps, hold: (rwm_args(steps), {},
                             rwm_work("rosenbrock", d, Cr, steps)),
        RWM_MAIN["iters"]))

    kernels.extend(phases_7_to_10(torch, gen))

    say(f"total {time.time() - t_start:.1f} s; nvidia-smi name, power.limit:")
    say(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
