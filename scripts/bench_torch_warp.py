"""Time the port's fused kernels above 64 dimensions
(``csrc/fused_pt_warp.cu``, ``csrc/fused_rwm_warp.cu``) at the shapes
their users run, with the team size the launch geometry picks and, where
the tree has team sizes, with each one forced.

    python scripts/bench_torch_warp.py [--tree DIR] [--out FILE] [--reps N]
                                       [--only REGEX] [--rwm-teams G,G]
                                       [--check FILE]

``--tree`` is a checkout of this repository whose ``rwm_pt_tpu_torch`` is
imported (default: the one holding this script), so that an earlier tree
unpacked with ``git archive`` is timed through its own code; run the
trees in turns on the same card (earlier, this, this, earlier) to compare
them.  A tree with team sizes (``_build.WARP_TEAMS``) is also timed with
each of its libraries' team sizes forced (``team=``).

Shapes (the rule's normal draw, ``lax_erfinv``): the d = 100 main shape,
PT on 65,536 replicas x T = 10 (swap every 100) and RWM on 65,536 chains,
2000 steps, on FullRosenbrock (variance 0.5^2/d) and the iso MVN
(2.38^2/d); the same at d = 200 (the 256 bucket), 500 (the 512 bucket)
and 1000 (the 1024 bucket); on FullRosenbrock, the grids between the
main shape and the campaigns (``GRIDS``: PT on 512 to 16,384 replicas x
T = 10, RWM on 1024 to 32,768 chains; the wide buckets at the studies'
1024 too), where the geometry's rule turns from the small team to
G = 32; one scale (the
middle of the reference's grid) of each of the reference's d = 100 RWM
campaigns
(``scripts/run_parity_matrix.sh:32, 36-40``: 512 chains, 100,000
iterations, Hypercube 200,000, burn-in 1000), in seconds a point; and, the
warp kernel forced (``warp=True``), the RWM study's shape (RoughCarpetScaled
d = 20, UniformRadius, 1024 chains, 20,000 steps) and the flagship PT and
RWM headline at d = 30; and the widest rows (``WIDE_ROWS``, labels
``wide ...``: 65,536 replicas x T or chains, 200 steps): PT at d = 2000 and
4000, T = 10 (FullRosenbrock, the iso MVN), IIDGamma at d = 2000, the iso
MVN at d = 500, T = 36 and d = 1000, T = 50 (a ladder no block holds),
RWM at d = 2000 and 4000 and IIDGamma's RWM at d = 2000, each with the
launch's registers and warps an SM.  In the 2048 and 4096 buckets RWM's
G = 32 launch (tag ``G32``) is one warp a chain at its raised launch bound
(13 chains and warps an SM at d = 2000, where an earlier tree's took 8):
the alternative its wide teams (``G64``, ``G128``) must beat.  Each
launch: a warm-up, then the best of
``--reps`` CUDA-event timings, beside ``chip_smoke.py::bound`` (this
script's checkout) and its share; ``--only`` times the shapes whose
label matches; ``--rwm-teams`` builds the RWM team libraries with these
team sizes (those a bucket takes: 64 and 128 in the 2048 and 4096 ones),
forced in this order, in place of ``_build.RWM_WARP_TEAMS`` (run ``16,32``
and ``32,16`` in turns to compare them).  ``--check FILE``
keeps a digest of every launch's outputs (x, lp, the counters and the Kahan
sums, hashed on the card) in FILE, or, where FILE holds another tree's,
compares them: every launch whose team size is the same and at most 32
must equal the other tree's bit for bit; in one run, a kind that sums its
log-density in index order (``INDEX_ORDER``) must give G = 32's digest at
the wide teams too.  Prints a line a launch and writes them as JSON to
``--out``, with the card's name and power limit.  Needs the card and
``nvcc``.
"""
import argparse
import glob
import inspect
import json
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C_MAIN, STEPS, SWAP, T_MAIN = 65536, 2000, 100, 10
# the reference's d = 100 RWM campaigns (chip_smoke.py::CAMPAIGNS)
CAMPAIGNS = (("MultivariateNormal", "Laplace", 100000),
             ("MultivariateNormal", "UniformRadius", 100000),
             ("IIDGamma", "Normal", 100000),
             ("Hypercube", "Normal", 200000))
CAMPAIGN_CHAINS, CAMPAIGN_BURN_IN = 512, 1000
# (d, algo) -> the replicas (chains) of the grids between the campaigns'
# 512 chains and the main shape's 65,536
GRIDS = {(100, "pt"): (512, 1024, 2048, 4096, 8192, 16384),
         (100, "rwm"): (2048, 4096, 8192, 16384, 32768),
         (200, "pt"): (1024, 4096, 16384),
         (200, "rwm"): (4096, 16384),
         (500, "pt"): (1024, 4096, 16384),
         (500, "rwm"): (1024, 4096, 16384),
         (1000, "pt"): (1024, 4096, 16384),
         (1000, "rwm"): (1024, 4096, 16384)}
# (algo, kind, d, T) of the widest rows, 200 steps at 65,536 replicas x T
# or chains (PERF.md's rows of the 2048 and 4096 buckets and the cluster
# build)
WIDE_ROWS = (("pt", "rosenbrock", 2000, 10), ("pt", "mvn_iso", 2000, 10),
             ("pt", "rosenbrock", 4000, 10), ("pt", "mvn_iso", 4000, 10),
             ("pt", "iid_gamma", 2000, 10), ("pt", "mvn_iso", 500, 36),
             ("pt", "mvn_iso", 1000, 50), ("rwm", "rosenbrock", 2000, 1),
             ("rwm", "mvn_iso", 2000, 1), ("rwm", "rosenbrock", 4000, 1),
             ("rwm", "mvn_iso", 4000, 1), ("rwm", "iid_gamma", 2000, 1))
WIDE_STEPS = 200
# the kinds whose log-density every team size sums in index order
INDEX_ORDER = ("iid_gamma", "iid_beta", "neal_funnel")


def digest(torch, t) -> str:
    """A hash of tensor ``t``'s bits, made on its device by chunks: two
    position-weighted int64 sums (wrapping) a chunk."""
    v = t.contiguous().view(-1)
    v = v.view(torch.int32) if v.element_size() == 4 else v
    h = []
    for c in v.split(1 << 26):
        c = c.to(torch.int64)
        w = torch.arange(c.numel(), device=c.device, dtype=torch.int64)
        h += [int(c.sum()), int((c * (2 * w + 1)).sum()),
              int((c * (w * w + 7)).sum())]
    return f"{t.dtype}{tuple(t.shape)}:{hash(tuple(h)) & (1 << 64) - 1:016x}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="time only the shapes whose label matches")
    ap.add_argument("--rwm-teams", default="",
                    help="team sizes of the wide RWM libraries, in the "
                    "order they are forced")
    ap.add_argument("--check", default="",
                    help="keep the outputs' digests here, or compare with "
                    "the ones another tree kept")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    from rwm_pt_tpu_torch.kernels import _build, fused_pt, fused_rwm
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.proposals import create_proposal_distribution
    from rwm_pt_tpu_torch.targets import get_target_distribution
    sys.path.insert(0, HERE)
    from chip_smoke import bound, pt_work, rwm_work, wide_target
    if a.rwm_teams:
        teams = tuple(int(g) for g in a.rwm_teams.split(","))
        _build.RWM_WARP_TEAMS.update({
            b: tuple(g for g in teams if g <= 32 or b > 1024)
            for b in _build.RWM_WARP_TEAMS})

    has_teams = "team" in inspect.signature(
        fused_pt.launch_pt_kernel).parameters
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"tree {os.path.abspath(a.tree)}; card {card}", flush=True)
    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa

    def target(kind, d):
        if kind == "rosenbrock":
            return (get_target_distribution("FullRosenbrock", d, device=dev),
                    0.5 ** 2 / d)
        if kind == "rough_carpet":
            return (get_target_distribution("RoughCarpetScaled", d,
                                            device=dev), 2.4654 ** 2 / d)
        return (get_target_distribution("MultivariateNormal", d, device=dev),
                2.38 ** 2 / d)

    # (label, algo, target, variance, C, T, steps, burn_in, proposal,
    #  warp forced, seconds a point)
    cases = []
    for d in (100, 200, 500, 1000):
        for algo in ("pt", "rwm"):
            for kind in ("rosenbrock", "mvn_iso"):
                tg, var = target(kind, d)
                cases.append((f"main {algo} {kind} d={d}", algo, tg, var,
                              C_MAIN, T_MAIN if algo == "pt" else 1, STEPS,
                              0, None, None, False))
    for (d, algo), sizes in GRIDS.items():
        tg, var = target("rosenbrock", d)
        cases += [(f"grid {algo} rosenbrock d={d} C={C}", algo, tg, var, C,
                   T_MAIN if algo == "pt" else 1, STEPS, 0, None, None,
                   False) for C in sizes]
    for name, prop, iters in CAMPAIGNS:
        (path,) = glob.glob(os.path.join(
            HERE, "data", "ref_averaged", f"{name}_{prop}_RWM_GPU_dim100_"
            f"{iters}iters_seeds*_averaged.json"))
        with open(path) as f:
            grid = json.load(f)["scale_param_range"]
        sc = float(grid[len(grid) // 2])
        params = ({"base_radius": sc} if prop == "UniformRadius"
                  else {"base_variance_vector": sc ** 2 / 100}
                  if prop == "Laplace" else
                  {"base_variance_scalar": sc ** 2 / 100})
        pr = create_proposal_distribution(
            100, {"name": prop, "params": params}, device=dev)
        cases.append((f"campaign {name} {prop} d=100 scale {sc:.4g}", "rwm",
                      get_target_distribution(name, 100, device=dev),
                      sc ** 2 / 100, CAMPAIGN_CHAINS, 1,
                      CAMPAIGN_BURN_IN + iters, CAMPAIGN_BURN_IN, pr, None,
                      True))
    rc20, var20 = target("rough_carpet", 20)
    study = create_proposal_distribution(
        20, {"name": "UniformRadius", "params": {"base_radius": 2.4654}},
        device=dev)
    rb30, var30 = target("rosenbrock", 30)
    for algo, kind, d, T in WIDE_ROWS:
        tg, var = (target(kind, d) if kind != "iid_gamma" else
                   wide_target(get_target_distribution, kind, d, dev))
        cases.append((f"wide {algo} {kind} d={d}"
                       + (f" T={T}" if algo == "pt" else ""), algo, tg, var,
                       C_MAIN, T, WIDE_STEPS, 0, None, None, False))
    cases += [("record RWM study RoughCarpetScaled d=20 UniformRadius",
               "rwm", rc20, var20, 1024, 1, 20000, 0, study, True, False),
              ("record flagship PT d=30", "pt", rb30, var30, C_MAIN, T_MAIN,
               STEPS, 0, None, True, False),
              ("record RWM headline d=30", "rwm", rb30, var30, C_MAIN, 1,
               STEPS, 0, None, True, False)]

    def launch_args(algo, tg, var, C, T, steps, burn_in, pr):
        d = tg.dim
        g = torch.Generator(device=dev).manual_seed(5)   # whatever --only
        if algo == "pt":
            betas = torch.logspace(0, -2, T, device=dev)
            kind, sig = fused_pt.rung_scales(pr, var, betas,
                                             torch.ones_like(betas))
            x0 = tg.init_sample(C, g).T[:, None].expand(d, T, C).contiguous()
            return (fused_pt.launch_pt_kernel,
                    (tg, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                     seed_key(3), 0, steps, burn_in, SWAP), kind)
        beta = torch.tensor(1.0, device=dev)
        kind, scale = fused_rwm.proposal_scale(pr, var, beta)
        x0 = tg.init_sample(C, g).T.contiguous()
        return (fused_rwm.launch_rwm_kernel,
                (tg, x0, zi(C), zf(C), beta, scale, seed_key(3), 0, steps,
                 burn_in), kind)

    cases = [c for c in cases if re.search(a.only, c[0])]
    libs = set()
    for _, algo, tg, var, C, T, steps, burn_in, pr, warp, _ in cases:
        kind = "Normal" if pr is None else pr.name
        libs.add(_build.lib_name(_build.library(f"fused_{algo}", kind,
                                                "lax_erfinv"),
                                 _build.target_kind(tg), tg.dim, warp))
    from rwm_pt_tpu_torch.kernels import ptxas_report
    for name, log in sorted(_build.build(sorted(libs)).items()):
        print(f"build {name}: " + "; ".join(
            f"{n} {r} regs, {f} B stack, {sp} B spill"
            for n, r, f, sp in sorted(ptxas_report.parse(log))), flush=True)

    res = {"tree": os.path.abspath(a.tree), "card": card, "cases": {},
           "check": {}}
    other = None
    if a.check and os.path.exists(a.check):
        with open(a.check) as f:
            other = json.load(f)
        print(f"check against {other['tree']}", flush=True)
    names = (("x", "lp", "acc", "swapacc", "betajump", "coldjump"),
             ("x", "lp", "acc", "jump"))
    for label, algo, tg, var, C, T, steps, burn_in, pr, warp, per_point \
            in cases:
        launch, args, kind = launch_args(algo, tg, var, C, T, steps,
                                         burn_in, pr)
        d = tg.dim
        tkind = _build.target_kind(tg)
        lib = _build.lib_name(_build.library(f"fused_{algo}", kind,
                                             "lax_erfinv"), tkind, d, warp)
        n_params = _build.kernel_target(tg)[1].numel()
        work = (pt_work(tkind, d, T, C, steps, burn_in, SWAP, prop=kind,
                        draw="lax_erfinv", n_params=n_params)
                if algo == "pt" else
                rwm_work(tkind, d, C, steps, prop=kind, draw="lax_erfinv",
                         n_params=n_params))
        b_ms, _, b_limit = bound(*work)
        geo = _build.launch_geometry(lib, d, C, T if algo == "pt" else 0,
                                     kind, "lax_erfinv", n_params)
        picked = getattr(geo, "team", 32)
        teams = ([None] + list(_build.library_teams(lib))
                 if has_teams else [None])
        rows = {}
        for team in teams:
            kw = dict(kind=kind, draw="lax_erfinv", warp=warp)
            if team is not None:
                kw["team"] = team
            out = launch(*args, **kw)
            torch.cuda.synchronize()
            best = math.inf
            for _ in range(a.reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = launch(*args, **kw)
                e1.record()
                torch.cuda.synchronize()
                best = min(best, e0.elapsed_time(e1))
            n = max(steps - burn_in, 1)
            acc = out[2].float().mean().item() / n
            tag = "picked" if team is None else f"G{team}"
            row = dict(ms=best, bound_ms=b_ms, bound_limit=b_limit,
                       bound_share=b_ms / best, acc=acc,
                       team=picked if team is None else team,
                       replicas=geo.replicas if team is None else None)
            if label.startswith("wide"):
                row.update(layout(_build, lib, d, C, T if algo == "pt"
                                  else 0, kind, n_params, team))
            if per_point:
                row["s_a_point"] = best / 1e3
            rows[tag] = row
            print(f"{label} [{tag}]: {best:.3f} ms, bound {b_ms:.3f} ms by "
                  f"{b_limit} ({100 * b_ms / best:.1f} %), G={row['team']}"
                  f", acc {acc:.4f}"
                  + (f", {row['registers']} registers, "
                     f"{row['warps_per_sm']} warps an SM, cluster "
                     f"{row['cluster']}" if "registers" in row else ""),
                  flush=True)
            if a.check:
                dig = {nm: digest(torch, o) for nm, o in
                       zip(names[algo == "rwm"], out)}
                res["check"].setdefault(label, {})[tag] = dict(
                    team=row["team"], digest=dig)
                check_one(other, res, label, tag, row["team"], dig, tkind)
        res["cases"][label] = rows
        del args
        torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    if a.check and other is None:
        with open(a.check, "w") as f:
            json.dump({"tree": res["tree"], "check": res["check"]}, f)


def layout(_build, lib, d, C, T, prop, n_params, team):
    """A launch's team size, blocks a cluster, registers and warps an SM
    (``_build.launch_geometry``, ``kernel_info``; what the tree has)."""
    geo = _build.launch_geometry(lib, d, C, T, prop, "lax_erfinv", n_params,
                                 team)
    name = _build.cluster_lib(lib) if getattr(geo, "cluster", 0) else lib
    kw = dict(team=geo.team)
    if getattr(geo, "cluster", 0):
        kw["cluster"] = geo.cluster
    info = _build.kernel_info(name, d, max(T, 1), geo.replicas, n_params,
                              **kw)
    return dict(registers=info["registers"], cluster=getattr(geo, "cluster",
                                                             0),
                warps_per_sm=info["blocks_per_sm"] * -(-geo.threads // 32),
                threads=geo.threads)


def check_one(other, res, label, tag, team, dig, kind):
    """Compare a launch's digests: with the other tree's at the same team
    size (at most 32), and for the kinds of ``INDEX_ORDER`` a wide team's
    with this run's G = 32.  Prints the verdict; a difference is printed,
    not raised, so that the run times every row."""
    if other is not None and team <= 32:
        theirs = other["check"].get(label, {}).get(tag)
        if theirs is not None and theirs["team"] == team:
            bad = [k for k, v in dig.items() if theirs["digest"].get(k) != v]
            print(f"check {label} [{tag}] against the other tree: "
                  + ("bit for bit" if not bad else f"DIFFERS in {bad}"),
                  flush=True)
    g32 = res["check"].get(label, {}).get("G32")
    if kind in INDEX_ORDER and team > 32 and g32 is not None:
        bad = [k for k, v in dig.items() if g32["digest"].get(k) != v]
        print(f"check {label} [{tag}] against G=32: "
              + ("bit for bit" if not bad else f"DIFFERS in {bad}"),
              flush=True)


if __name__ == "__main__":
    main()
