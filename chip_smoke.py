#!/usr/bin/env python3
"""On-card smoke gate and flagship measurement of the PyTorch/CUDA port.

    python3 chip_smoke.py          # one CUDA card; exits non-zero on failure

Drives ``rwm_pt_tpu_torch`` (never JAX) in phases, one line each:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: both kernels from ``rwm_pt_tpu_torch/kernels/csrc`` (one ``nvcc``
   each, in parallel), with ptxas registers and spills per instantiation;
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

The line before the last holds the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import re
import subprocess
import sys
import time

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
# csrc/*.cuh (an FMA counts 2; logf, sqrtf, expf 1 each; selects and
# integer work 0):
#   ICDF normal: cvt+scale 2, 2u-1+2^-24 3, (1-x)(1+x) 3, fmax 1, logf 1,
#     neg 1, then one branch of Giles' polynomial: w-2.5 1 and 8 FMAs 16
#     (the tail branch, w >= 5, takes sqrtf-3 instead of w-2.5, one more
#     op on about 0.3% of draws, left out), x*p 1, sqrt2* 1 = 30;
#     increment and proposal 2  -> 32 per coordinate.  The kernel
#     evaluates both polynomials and selects; the bound counts one.
#   log-density: Rosenbrock 9 per term (d-1 terms) + 1; MVN iso 4 d + 2
#   accept: lp' - lp, *beta, expf, cvt+scale of u, 2 compares -> 7
#   squared jump (cold rung / RWM chain) 3 d + Kahan 4
#   swap pair: 2 subs, mul, expf, compare, Kahan 5 -> 10
# Philox4x32-10 integer work (100 int ops per block of 4 words) is reported
# beside it and left out of the bound: the published table has no int32 rate.
def lp_flops(kind, d):
    return 9 * (d - 1) + 1 if kind == "rosenbrock" else 4 * d + 2


def pt_work(kind, d, T, C, steps, burn_in, swap_every, step0=0):
    n_events = (step0 + steps) // swap_every - max(burn_in, step0) // swap_every
    mh = (32 * d + lp_flops(kind, d) + 7) * T
    flops = C * (steps * (mh + 3 * d + 4) + n_events * 10 * (T - 1)
                 + T * lp_flops(kind, d))
    blocks = C * T * steps * -(-(d + 1) // 4)
    int_ops = 100 * blocks
    nbytes = C * (2 * d * T * 4 + T * 4 + 2 * T * 4 + 6 * 4)
    return flops, int_ops, nbytes


def rwm_work(kind, d, C, steps):
    flops = C * (steps * (32 * d + lp_flops(kind, d) + 7 + 3 * d + 4)
                 + lp_flops(kind, d))
    int_ops = 100 * C * steps * -(-(d + 1) // 4)
    nbytes = C * (2 * d * 4 + 4 + 2 * 4 + 2 * 4)
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


def kernel_record(torch, name, source, replaces, launches, launch, plain,
                  make_args, names, iters, work):
    """Time kernel ``name`` alone at its main path's size (``iters`` steps,
    best of 3), then at the same shapes over HOLD_STEPS steps time it again,
    time its plain version once, hold the two together (phase 3's checks)
    and set both kernel times beside their bounds.  ``ms``, ``plain_ms``
    and ``bound_ms`` of the record are for the HOLD_STEPS run, the
    ``main_path_*`` keys for the main path's size."""
    from rwm_pt_tpu_torch.kernels import agreement
    full_args = make_args(iters)
    full_ms, _ = cuda_ms(torch, lambda: launch(*full_args), reps=3)
    del full_args
    hold_args = make_args(HOLD_STEPS)
    ms, k = cuda_ms(torch, lambda: launch(*hold_args), reps=3)
    plain_ms, p = cuda_ms(torch, lambda: plain(*hold_args))
    ag = agreement.hold(k, p, names)
    flops, int_ops, nbytes = work(HOLD_STEPS)
    b_ms, b_by = bound(flops, nbytes)
    full_flops, full_int, full_bytes = work(iters)
    full_b_ms, full_by = bound(full_flops, full_bytes)
    say(f"phase 6 {name} kernel: {full_ms:.3f} ms for {iters} steps, bound "
        f"{full_b_ms:.3f} ms by {full_by} ({full_flops:.4g} flops, "
        f"{full_int:.4g} Philox int ops, {full_bytes:.4g} B); {HOLD_STEPS} "
        f"steps at the same shapes: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms ({plain_ms / HOLD_STEPS:.3f} ms/step), bound "
        f"{b_ms:.3f} ms; {agreement.describe(ag)}")
    if ag.frac < AGREE_MIN or ag.mismatched:
        fail(f"{name} disagrees with its plain version at main-path shapes")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=ag.max_dx, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None, steps=HOLD_STEPS,
        agree_frac=ag.frac, max_rel_err=ag.max_rel, flops=flops,
        philox_int_ops=int_ops, bytes=nbytes, main_path_steps=iters,
        main_path_ms=full_ms, main_path_bound_ms=full_b_ms)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from rwm_pt_tpu_torch.kernels import (_build, agreement, fused_pt,
                                              fused_rwm, run_pt, run_pt_fused,
                                              run_rwm_fused)
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
    say(f"phase 2 build: both kernels in {time.time() - t0:.1f} s")

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
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    Cn = 4096

    def max_z(ev, fresh):
        def stats(x):
            f = torch.cat([x, x * x, mvn.log_density_td(x)[None]], dim=0)
            return f.mean(1), f.var(1, unbiased=False)
        m1, v1 = stats(ev)
        m2, v2 = stats(fresh)
        return ((m1 - m2).abs() / torch.sqrt((v1 + v2) / Cn + 1e-12)) \
            .max().item()

    exact = mvn.direct_sample(Cn, 1.0, g).T
    r = run_rwm_fused(mvn, seed, base_variance=bv, num_chains=Cn,
                      num_iterations=50, init_states=exact, device=dev)
    z_rwm = max_z(r.state.x, mvn.direct_sample(Cn, 1.0, g).T)
    bi = torch.logspace(0, math.log10(0.09), 6, device=dev)
    cube = torch.stack([mvn.direct_sample(Cn, b.item(), g).T for b in bi],
                       dim=1)
    r = run_pt_fused(mvn, seed + 1, bi, base_variance=bv, num_chains=Cn,
                     num_iterations=60, swap_every=5, init_states=cube,
                     device=dev)
    z_pt = max(max_z(r.state.x[:, t], mvn.direct_sample(Cn, b.item(), g).T)
               for t, b in enumerate(bi))
    sw = r.swap_acceptance_rate.mean().item()
    say(f"phase 5 invariance (seed {seed}): max z RWM {z_rwm:.2f}, PT "
        f"{z_pt:.2f} over 6 rungs (< {Z_INV_MAX}); PT swap acc {sw:.3f}")
    if max(z_rwm, z_pt) >= Z_INV_MAX or sw <= 0.02:
        fail("invariance check failed")

    # ---- 6. main paths through the entry points, then kernel vs plain
    kernels = []
    d, T, C = FLAG["dim"], FLAG["T"], FLAG["C"]
    rb = FullRosenbrock.create(d, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    fused_pt.launch_pt_kernel.launches = 0
    fused_rwm.launch_rwm_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pt_fused(rb, 0, betas, base_variance=FLAG["base_variance"],
                       num_chains=C, num_iterations=FLAG["iters"],
                       swap_every=FLAG["swap_every"], device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pt_launches = fused_pt.launch_pt_kernel.launches
    if pt_launches < 1 or fused_rwm.launch_rwm_kernel.launches:
        fail(f"flagship path launches: fused_pt {pt_launches}, fused_rwm "
             f"{fused_rwm.launch_rwm_kernel.launches}")
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
        fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain, pt_args,
        agreement.PT_OUTPUTS, FLAG["iters"],
        lambda steps: pt_work("rosenbrock", d, T, C, steps, 0,
                              FLAG["swap_every"])))
    del res, st

    # RWM main path: the headline RWM workload
    Cr = RWM_MAIN["C"]
    rwm_kw = dict(base_variance=RWM_MAIN["base_variance"], num_chains=Cr,
                  num_iterations=RWM_MAIN["iters"], device=dev)
    fused_pt.launch_pt_kernel.launches = 0
    fused_rwm.launch_rwm_kernel.launches = 0
    rr = run_rwm_fused(rb, 0, **rwm_kw)
    torch.cuda.synchronize()
    rwm_launches = fused_rwm.launch_rwm_kernel.launches
    if rwm_launches < 1 or fused_pt.launch_pt_kernel.launches:
        fail(f"RWM path launches: fused_rwm {rwm_launches}, fused_pt "
             f"{fused_pt.launch_pt_kernel.launches}")
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
        fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain, rwm_args,
        agreement.RWM_OUTPUTS, RWM_MAIN["iters"],
        lambda steps: rwm_work("rosenbrock", d, Cr, steps)))

    say(f"total {time.time() - t_start:.1f} s; nvidia-smi name, power.limit:")
    say(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()
