"""Time SuperFunnel's kernels (kind 12) built with the dataset's shape
fixed against the run-time-shape library, in one process on one card:
the thread kernels (``csrc/fused_pt.cu``, ``csrc/fused_rwm.cu``, d <= 64)
and, in the team section, the team kernels (``csrc/fused_pt_warp.cu``,
``csrc/fused_rwm_warp.cu``, d > 64).

    python scripts/bench_torch_super_funnel.py [--out FILE] [--reps N]
                                               [--only REGEX]
                                               [--same-code DIR]

The reference's dataset (J = 5, K = 3, n = 20, seed 42: d = 26), the
Normal proposal with the rule's draw, variance 0.01, from the default init
1e-8 N(0, 1) (most states start at -inf), at the shapes its users run:

* ``pt main``: 65,536 replicas x T = 8 (the geometric ladder), 2000
  steps, swap every 100 (chip_smoke.py phase 17's main path);
* ``rwm main``: 65,536 chains, 2000 steps;
* ``rwm study``: 1024 chains, one config of ``launch_rwm_pod.sh``
  (200,000 iterations after a burn-in of 1000);
* ``pt d<d>`` / ``rwm d<d>``: the main paths' sizes on the dataset of
  each register bucket (J = 2, K = 1: d = 8; J = 3, K = 2: d = 14; the
  reference's d = 26; J = 10, K = 3: d = 46), the run-time and the
  route's library alone;
* ``pt laplace``, ``pt uniform_radius``, ``rwm laplace``, ``rwm
  uniform_radius``: the main paths with the other proposals (matched to
  the Normal's variance, ``chip_smoke.py::proposal_params``), and ``pt
  T10``: the PT main path on a ladder of 10 rungs (more than the 8 that
  a fixed PT build's 256-thread launch bound was sized for), the
  run-time and the route's library alone.

Libraries: the run-time-shape one (``specialize=False``, timed first and
last), the fixed-shape build the route takes (``specialize=True``), and
fixed-shape builds of each observation unroll of ``UNROLLS`` at each
block count of ``BLOCKS`` (the launch bound's blocks an SM, which cap the
registers; the study's shape: each of ``STUDY_UNROLLS`` at the route's
blocks), made by setting ``_build.SF_UNROLL`` and ``SF_MIN_BLOCKS`` in
this process, which the fixed-shape library names carry (``_build.
sf_tag``).
Each launch: a 10-step warm-up, then the best of ``--reps`` CUDA-event
timings; every fixed-shape build's outputs must equal the run-time
library's bit for bit.  Beside each: ptxas's registers, stack frame and
spills, the launch geometry (replicas a block, blocks and warps an SM by
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and, but in a build
unrolled whole, the SASS instructions and MUFU an observation
(``chip_smoke.py::sf_sass``, which reads a loop's).
Team section (labels ``team ...``; ``--only team`` runs it alone): the
team shapes of chip_smoke.py's phase 17, J = 10, K = 5 (d = 68, ``.w128``)
and J = 40, K = 3 (d = 166, ``.w256``), n = 20, Normal:

* ``team pt d68`` / ``d166``: 16,384 replicas x T = 8, 50 steps;
  ``team rwm d68`` / ``d166``: 65,536 chains, 50 steps (PERF.md's
  shapes);
* ``... full``: the full width, 65,536 replicas x T = 8 or 65,536
  chains, 2000 steps, swap every 100;
* ``team pt d68 laplace`` / ``uniform_radius``, ``team rwm d68 ..``: the
  50-step shapes with the other proposals.

At every team size G of the bucket, the run-time team library
(``specialize=False``) and the route's fixed team build, alternating,
best of ``--reps`` each, outputs equal bit for bit; at the 50-step Normal
shapes and the geometry's G also a fixed build of each observation
unroll of ``TEAM_UNROLLS`` (set through ``_build.SF_UNROLL``'s
``fused_*_warp`` keys).  Beside
each: registers, warps an SM, the bound (``chip_smoke.py::bound``, the
valid log-densities counted by the plain version's run on the same
inputs, ``chip_smoke.py::sf_counted``) and its share, and the SASS
instructions an observation (``chip_smoke.py::sf_sass``).

Prints a line a launch and writes them as JSON to ``--out``, with the
card's name and power limit.  ``--same-code DIR`` first builds, from this
checkout and from the one at ``DIR`` (an earlier tree unpacked with ``git
archive``), the thread kernels' Normal libraries with the rule's draw for
every other target kind at d = 30 and the team kernels' at d = 100, and
compares their ``cuobjdump -sass`` text (but the anonymous namespace's
per-file hash), and fails where any differs.  Needs the card (the
comparison, only ``nvcc``).
"""
import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SF = dict(J=5, K=3, n=20)     # n of every shape
VAR = 0.01
UNROLLS = (20, 10, 5, 4, 2, 1)   # observations a trip; 20: unrolled whole
STUDY_UNROLLS = (20, 5, 4, 2)     # the study's shape: fewer (~4 s a run)
# blocks of the launch bound an SM: PT of 256 threads (no cap, 128, 80, 64
# registers), RWM of 128 (no cap, 128, 80, 64)
BLOCKS = {"pt": (1, 2, 3, 4), "rwm": (1, 4, 6, 8)}
# label -> (algo, replicas or chains, steps, burn-in, (J, K), proposal,
# PT's rungs)
SHAPES = {"pt main": ("pt", 65536, 2000, 0, (5, 3), "Normal", 8),
          "rwm main": ("rwm", 65536, 2000, 0, (5, 3), "Normal", 0),
          "rwm study": ("rwm", 1024, 201000, 1000, (5, 3), "Normal", 0)}
SHAPES.update({f"{algo} d{J + J * K + K + 3}": (
    algo, 65536, 2000, 0, (J, K), "Normal", 8 if algo == "pt" else 0)
    for algo in ("pt", "rwm") for J, K in ((2, 1), (3, 2), (5, 3), (10, 3))})
SHAPES.update({f"{algo} {tag}": (algo, 65536, 2000, 0, (5, 3), prop,
                                 8 if algo == "pt" else 0)
               for algo in ("pt", "rwm")
               for prop, tag in (("Laplace", "laplace"),
                                 ("UniformRadius", "uniform_radius"))})
SHAPES["pt T10"] = ("pt", 65536, 2000, 0, (5, 3), "Normal", 10)
SWAP = 100
# the team section: label -> (algo, replicas or chains, steps, (J, K),
# proposal); PT on the geometric ladder, T = 8
TEAM = {}
for (J, K), dd in (((10, 5), 68), ((40, 3), 166)):
    for algo, C in (("pt", 16384), ("rwm", 65536)):
        TEAM[f"team {algo} d{dd}"] = (algo, C, 50, (J, K), "Normal")
        TEAM[f"team {algo} d{dd} full"] = (algo, 65536, 2000, (J, K),
                                           "Normal")
for algo, C in (("pt", 16384), ("rwm", 65536)):
    for prop, tag in (("Laplace", "laplace"),
                      ("UniformRadius", "uniform_radius")):
        TEAM[f"team {algo} d68 {tag}"] = (algo, C, 50, (10, 5), prop)
TEAM_UNROLLS = (20, 10, 5, 4, 2, 1)


@contextlib.contextmanager
def chosen(_build, source, choice):
    """Within the block, fixed-shape builds of kernel ``source``
    (``fused_pt``, ``fused_rwm``, or ``fused_pt_warp``, ``fused_rwm_warp``
    for the team builds) take ``choice``, (observations a trip, blocks an
    SM or None: the route's), or the route's choices where ``choice`` is
    None."""
    saved = dict(_build.SF_UNROLL), dict(_build.SF_MIN_BLOCKS)
    if choice is not None:
        _build.SF_UNROLL[source] = choice[0]
        if choice[1] is not None:
            _build.SF_MIN_BLOCKS[source] = choice[1]
    try:
        yield
    finally:
        _build.SF_UNROLL.update(saved[0])
        _build.SF_MIN_BLOCKS.update(saved[1])


def same_code(tree):
    """``{library: whether its SASS is the same in this checkout and in
    ``tree``}`` for every non-SuperFunnel kind's d = 30 thread library and
    d = 100 team library of both kernels (Normal, ``lax_erfinv``); each
    tree builds in a process of its own."""
    prog = ("import json, subprocess, sys; sys.path.insert(0, sys.argv[1]); "
            "from rwm_pt_tpu_torch.kernels import _build; "
            "names = [_build.lib_name(v, k, d) for v in "
            "('fused_pt_lax_erfinv', 'fused_rwm_lax_erfinv') for k in "
            "_build.TARGET_KINDS if k != 'super_funnel' for d in (30, 100)]; "
            "_build.build(names); "
            "exe = _build._nvcc().replace('nvcc', 'cuobjdump'); "
            "out = {n: subprocess.run([exe, '-sass', str(_build._lib_path("
            "n))], capture_output=True, text=True).stdout for n in names}; "
            "print(json.dumps({n: t[t.index('Function'):] for n, t in "
            "out.items()}))")
    sass = [json.loads(subprocess.run(
        [sys.executable, "-c", prog, os.path.abspath(t)], check=True,
        capture_output=True, text=True).stdout.splitlines()[-1])
        for t in (HERE, tree)]
    # an anonymous namespace's mangled name carries a hash of its file's
    # path, which differs between checkouts
    anon = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
    out = {}
    for n, text in sass[0].items():
        a, b = (anon.sub("_GLOBAL__N__", t).splitlines()
                for t in (text, sass[1].get(n, "")))
        out[n] = a == b
        if a != b:          # the first lines that differ, for the record
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            print(f"{n}: {len(a)} and {len(b)} lines of SASS; line {i}: "
                  f"{a[i:i + 3]} | {b[i:i + 3]}", flush=True)
    return out


def launch_args(torch, dev, algo, tg, C, steps, burn_in, prop, ladder):
    """(launch, plain version, its arguments, its keywords) of a run of
    ``algo`` on SuperFunnel ``tg`` at C replicas (PT, on ``ladder``) or
    chains, the rule's draw, from the default init (seeded)."""
    from chip_smoke import proposal_params
    from rwm_pt_tpu_torch.kernels import draws, fused_pt, fused_rwm
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.proposals import create_proposal_distribution

    zi = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)  # noqa
    zf = lambda *s: torch.zeros(*s, dtype=torch.float32, device=dev)  # noqa
    g = torch.Generator(device=dev).manual_seed(5)
    draw = draws.resolve_normal_impl(algo, C, "super_funnel")
    pr = None if prop == "Normal" else create_proposal_distribution(
        tg.dim, {"name": prop, "params": proposal_params(
            prop, tg.dim, VAR)}, device=dev)
    if algo == "pt":
        betas = torch.tensor(ladder, device=dev)
        T = len(ladder)
        kind, sig = fused_pt.rung_scales(pr, VAR, betas,
                                         torch.ones_like(betas))
        x0 = tg.init_sample(C, g).T[:, None].expand(
            tg.dim, T, C).contiguous()
        return (fused_pt.launch_pt_kernel, fused_pt._run_pt_fused_plain,
                (tg, x0, zi(T, C), zi(C), zf(C), zf(C), betas, sig,
                 seed_key(3), 0, steps, burn_in, SWAP),
                dict(kind=kind, draw=draw))
    beta = torch.tensor(1.0, device=dev)
    kind, scale = fused_rwm.proposal_scale(pr, VAR, beta)
    x0 = tg.init_sample(C, g).T.contiguous()
    return (fused_rwm.launch_rwm_kernel, fused_rwm._run_rwm_fused_plain,
            (tg, x0, zi(C), zf(C), beta, scale, seed_key(3), 0, steps,
             burn_in), dict(kind=kind, draw=draw))


def team_section(torch, dev, shapes, reps):
    """The team section (module docstring): ``{label: {tag: row}}``."""
    from chip_smoke import bound, pt_work, rwm_work, sf_counted, sf_sass
    from rwm_pt_tpu_torch.kernels import _build, draws, ptxas_report
    from rwm_pt_tpu_torch.ladders import construct_geometric_ladder
    from rwm_pt_tpu_torch.targets import get_target_distribution

    ladder = construct_geometric_ladder()
    T = len(ladder)
    targets = {jk: get_target_distribution(
        "SuperFunnel", 0, J=jk[0], K=jk[1], n_per_group=SF["n"], device=dev)
        for jk in {v[3] for v in shapes.values()}}

    def variant(algo, prop, C):
        draw = draws.resolve_normal_impl(algo, C, "super_funnel")
        return draw, _build.library(f"fused_{algo}", prop, draw)

    # each shape's launches: (tag, specialize=, team= or None: the
    # geometry's, choice for chosen())
    plans, names = {}, set()
    for label, (algo, C, steps, jk, prop) in shapes.items():
        tg = targets[jk]
        draw, v = variant(algo, prop, C)
        dmax = _build.warp_bucket(tg.dim)
        plan = []
        for g in _build.WARP_TEAMS[dmax]:
            if algo == "pt" and T * g > _build.pt_team_threads(dmax, g):
                continue
            plan += [(f"run-time G={g}", False, g, None),
                     (f"fixed G={g}", True, g, None)]
        if steps == 50 and prop == "Normal":
            plan += [(f"u{u}", True, None, (u, None)) for u in TEAM_UNROLLS]
        plans[label] = plan
        for _, spec, _, choice in plan:
            with chosen(_build, f"fused_{algo}_warp", choice):
                names.add(_build.route(v, tg, specialize=spec)[0])
    logs = _build.build(sorted(names))
    info = {}
    for name in sorted(names):
        regs = "; ".join(f"{n} {r} regs, {f} B stack, {sp} B spill"
                         for n, r, f, sp in sorted(ptxas_report.parse(
                             logs[name])))
        sf = _build.fixed_shape(name)
        sass = None if sf and sf["unroll"] == sf["n"] else {
            fn: (round(m, 3), round(i, 2), c)
            for fn, (m, i, c) in sf_sass(_build, name).items()}
        info[name] = dict(ptxas=regs, sass_mufu_instructions_classes=sass)
        read = "not read (unrolled whole)" if sass is None else sass
        print(f"team build {name}: {regs}; SASS (MUFU, instructions, "
              f"classes) an observation {read}", flush=True)

    out = {}
    for label, (algo, C, steps, jk, prop) in shapes.items():
        tg = targets[jk]
        draw, v = variant(algo, prop, C)
        J, K = jk
        launch, plain, args, kw = launch_args(torch, dev, algo, tg, C, steps,
                                              0, prop, ladder)
        kind, at = kw["kind"], 10 if algo == "pt" else 8
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        (_, valid) = sf_counted(plain, args, kw)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        n_params = _build.kernel_target(tg)[1].numel()
        sf = (J, K, SF["n"], valid)
        work = (pt_work("super_funnel", tg.dim, T, C, steps, 0, SWAP,
                        prop=kind, draw=draw, n_params=n_params, sf=sf)
                if algo == "pt" else
                rwm_work("super_funnel", tg.dim, C, steps, prop=kind,
                         draw=draw, n_params=n_params, sf=sf))
        b_ms, _, b_lim = bound(*work)
        evals = C * (T if algo == "pt" else 1) * (steps + 1)
        print(f"{label}: plain {plain_ms:.1f} ms, {valid} of {evals} "
              f"log-densities valid ({100 * valid / evals:.2f} %); bound "
              f"{b_ms:.3f} ms by {b_lim}", flush=True)
        short = args[:at] + (10, 0) + args[at + 2:]
        plan = plans[label]
        best, first = {}, {}
        for rnd in range(reps):
            for tag, spec, g, choice in plan:
                with chosen(_build, f"fused_{algo}_warp", choice):
                    tkw = dict(kw, specialize=spec,
                               **({} if g is None else {"team": g}))
                    if rnd == 0:
                        launch(*short, **tkw)
                    e0.record()
                    o = launch(*args, **tkw)
                    e1.record()
                    torch.cuda.synchronize()
                    best[tag] = min(best.get(tag, math.inf),
                                    e0.elapsed_time(e1))
                    if rnd == 0:
                        first[tag] = o
                    del o
        rows = {}
        for tag, spec, g, choice in plan:
            with chosen(_build, f"fused_{algo}_warp", choice):
                lib, _, words = _build.route(v, tg, specialize=spec)
                geo = _build.launch_geometry(lib, tg.dim, C,
                                             T if algo == "pt" else 0, prop,
                                             draw, words.numel(), team=g)
            occ = _build.kernel_info(lib, tg.dim, T if algo == "pt" else 1,
                                     geo.replicas, words.numel(),
                                     team=geo.team)
            ref = first[f"run-time G={geo.team}"]
            equal = all(torch.equal(x, y) for x, y in zip(first[tag], ref))
            warps = occ["blocks_per_sm"] * -(-geo.threads // 32)
            ms = best[tag]
            rows[tag] = dict(lib=lib, team=geo.team, ms=ms,
                             equal_to_run_time=equal,
                             registers=occ["registers"],
                             replicas=geo.replicas,
                             blocks_per_sm=occ["blocks_per_sm"],
                             warps_per_sm=warps, bound_ms=b_ms,
                             bound_share=b_ms / ms, plain_ms=plain_ms,
                             valid_share=valid / evals, **info[lib])
            print(f"{label} [{tag}] {lib} G={geo.team}: {ms:.3f} ms "
                  f"({100 * b_ms / ms:.1f} % of the {b_ms:.3f} ms bound), "
                  f"{occ['registers']} regs, R={geo.replicas}, "
                  f"{occ['blocks_per_sm']} blocks, {warps} warps an SM; "
                  f"outputs equal to the run-time library's at G="
                  f"{geo.team}: {equal}", flush=True)
            if not equal:
                sys.exit(f"{label} [{tag}]: outputs differ from the "
                         f"run-time library's")
        out[label] = rows
        del args, short, first
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--same-code", metavar="DIR",
                    help="compare the other kinds' SASS with DIR's tree")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="time only the shapes whose label matches")
    a = ap.parse_args()
    if a.same_code:
        same = same_code(a.same_code)
        print(f"same SASS as {a.same_code}'s in {sum(same.values())} of "
              f"{len(same)} libraries; differ: "
              f"{[n for n, v in same.items() if not v]}", flush=True)
        if not all(same.values()):
            sys.exit("the other kinds' code differs from the earlier tree's")
    import torch

    from chip_smoke import sf_sass
    from rwm_pt_tpu_torch.kernels import _build, draws, ptxas_report
    from rwm_pt_tpu_torch.ladders import construct_geometric_ladder
    from rwm_pt_tpu_torch.targets import get_target_distribution

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card {card}", flush=True)
    targets = {jk: get_target_distribution(
        "SuperFunnel", 0, J=jk[0], K=jk[1], n_per_group=SF["n"], device=dev)
        for jk in {v[4] for v in SHAPES.values()}}
    ladders = {8: construct_geometric_ladder(),
               10: [10 ** (-2 * t / 9) for t in range(10)]}
    def variants(label, algo):
        """(tag, specialize=, choice for :func:`chosen`) of the libraries
        a shape times."""
        out = [("run-time", False, None), ("route", True, None)]
        if "main" not in label and "study" not in label:
            return out
        blocks = BLOCKS[algo] if "main" in label else (None,)
        for u in UNROLLS if "main" in label else STUDY_UNROLLS:
            for b in blocks:
                out.append((f"u{u}" + (f"b{b}" if b is not None else ""),
                            True, (u, b)))
        return out

    shapes = {k: v for k, v in SHAPES.items() if re.search(a.only, k)}
    libs = {}
    for label, (algo, C, _, _, jk, prop, _) in shapes.items():
        draw = draws.resolve_normal_impl(algo, C, "super_funnel")
        variant = _build.library(f"fused_{algo}", prop, draw)
        for tag, spec, choice in variants(label, algo):
            with chosen(_build, f"fused_{algo}", choice):
                libs[(label, tag)] = _build.route(variant, targets[jk],
                                                  specialize=spec)[0]
    logs = _build.build(sorted(set(libs.values())))
    info = {}
    for name in sorted(set(libs.values())):
        regs = "; ".join(f"{n} {r} regs, {f} B stack, {sp} B spill"
                         for n, r, f, sp in sorted(ptxas_report.parse(
                             logs[name])))
        sf = _build.fixed_shape(name)
        sass = None if sf and sf["unroll"] == sf["n"] else {
            fn: (round(m, 3), round(i, 2))
            for fn, (m, i, _) in sf_sass(_build, name).items()}
        info[name] = dict(ptxas=regs, sass_mufu_and_instructions=sass)
        read = "not read (unrolled whole)" if sass is None else sass
        print(f"build {name}: {regs}; SASS (MUFU, instructions) an "
              f"observation {read}", flush=True)

    res = {"card": card, "dataset": SF, "cases": {}}
    for label, (algo, C, steps, burn_in, jk, prop, T) in shapes.items():
        tg = targets[jk]
        launch, _, args, kw = launch_args(torch, dev, algo, tg, C, steps,
                                          burn_in, prop, ladders[T or 8])
        at = 10 if algo == "pt" else 8           # total, burn_in
        short = args[:at] + (10, 0) + args[at + 2:]
        rows, ref = {}, None
        order = variants(label, algo)
        for tag, spec, choice in order + [("run-time again", False, None)]:
            lib = libs[(label, tag if tag != "run-time again"
                        else "run-time")]
            with chosen(_build, f"fused_{algo}", choice):
                launch(*short, **kw, specialize=spec)
                best, out = math.inf, None
                for _ in range(a.reps):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = launch(*args, **kw, specialize=spec)
                    e1.record()
                    torch.cuda.synchronize()
                    best = min(best, e0.elapsed_time(e1))
            if ref is None:
                ref = out
            equal = all(torch.equal(x, y) for x, y in zip(out, ref))
            geo = _build.launch_geometry(
                lib, tg.dim, C, T, prop, kw["draw"],
                _build.kernel_target(tg)[1].numel())
            occ = _build.kernel_info(lib, tg.dim, T or 1, geo.replicas,
                                     _build.kernel_target(tg)[1].numel(),
                                     runtime_r=geo.runtime_r)
            warps = occ["blocks_per_sm"] * -(-geo.threads // 32)
            acc = out[2].float().mean().item() / max(steps - burn_in, 1)
            rows[tag] = dict(lib=lib, ms=best, equal_to_run_time=equal,
                             registers=occ["registers"],
                             replicas=geo.replicas,
                             runtime_r=geo.runtime_r,
                             blocks_per_sm=occ["blocks_per_sm"],
                             warps_per_sm=warps, acc=acc, **info[lib])
            print(f"{label} [{tag}] {lib}: {best:.3f} ms, "
                  f"{occ['registers']} regs, R={geo.replicas}"
                  f"{' (run-time R)' if geo.runtime_r else ''}, "
                  f"{occ['blocks_per_sm']} blocks, {warps} warps an SM; acc "
                  f"{acc:.5f}; outputs equal to the run-time library's: "
                  f"{equal}", flush=True)
            if not equal:
                sys.exit(f"{label} [{tag}]: outputs differ from the "
                         f"run-time library's")
            del out
        res["cases"][label] = rows
        del args, short, ref
        torch.cuda.empty_cache()
    team = {k: v for k, v in TEAM.items() if re.search(a.only, k)}
    if team:
        res["team"] = team_section(torch, dev, team, a.reps)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
