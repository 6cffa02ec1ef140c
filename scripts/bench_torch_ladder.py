"""Measure the one-launch ladder kernel (``csrc/ladder_build.cu``) on the
card: its libraries' registers and occupancy, the SASS of two of them, a
sweep over the samples a probe, the split of a probe's time from
``%globaltimer`` stamps, the wrapper's host time and, given an earlier
tree's kernel source, that kernel against this one in turns.

    python scripts/bench_torch_ladder.py [--parent DIR] [--out FILE]
                                         [--reps N] [--only REGEX]

Both kernels are compiled here from their sources with the flags of
``_build`` (``-DRWM_PT_TARGET``, ``-DRWM_PT_DMAX``), into
``scratch_chip/bench_ladder/``, and called through one launch of their C
entry point ``rwm_pt_ladder_build`` (the same arguments in both trees), on
inputs made once a case by this tree's wrapper helpers
(``_build.kernel_target``, ``ladder_build.sampler_params``).  ``--parent``
is a checkout (or its ``rwm_pt_tpu_torch/kernels/csrc``) holding the
earlier kernel, e.g. the parent commit unpacked with ``git archive`` into
``scratch_chip/parent``.

Sections (each prints lines and goes into the JSON of ``--out``, with the
card's name and power limit):

* ``libraries``: registers, local bytes, blocks and warps an SM of every
  library the smoke's phase 18 builds (the 11 kinds at d = 10, the iso MVN
  at d = 100), from the library's own info entry point;
* ``sass``: static counts of ``ladder_build.three_mixture.d16`` and
  ``ladder_build.mvn_iso.d128`` (``cuobjdump -sass``): instructions,
  Philox multiplies (lines holding the constant 0xd2511f53: one or two a
  round), MUFU, local loads and stores, shuffles, barriers, atomics,
  branches and calls;
* ``sweep``: ThreeMixture d = 10 and the iso MVN d = 100 at N = 3000,
  20,000, 50,000 and 10^6 samples a side (tolerance 0.01, seed 1, the
  harness's eager room), device µs a probe (CUDA events, best of
  ``--reps``) and the least-squares fixed µs a probe and ns a sample;
* ``stamps``: at the same N, this tree's measuring build
  (``ladder_build.probe_split``: ``-DRWM_PT_LADDER_STAMPS``), the mean µs
  a probe of its four parts: ``work``, from the probe's start to the last
  block's arrival; up to ``ladder_build.EVERY_TILES`` tiles ``barrier``,
  to the latest block seeing every arrival, then ``reduce``, to its slot
  sums done; above, ``reduce``, to the last block's sum published, then
  ``barrier``, to the latest block holding it; ``next``, to the latest
  block's search done (the next probe's start);
* ``host``: the wrapper's host µs a build at N = 3000 (``host_us``: each
  of ``--host-reps`` calls' wall time, synchronised before and after,
  less the best device time of its library's launch alone; the least and
  the median), each tree's wrapper in a process of its own
  (``--host-only [--tree DIR]``), in turns with ``--parent``, and this
  tree's again in the bench's own process after the sweep;
* ``turns`` (with ``--parent``): every phase 18 hold (the 11 kinds at
  d = 10, N = 20,000), ThreeMixture at the harness's N = 3000, the d = 100
  hold, the production build (N = 10^6, tolerance 1e-4, 1000 pn steps),
  the full MVN at d = 30 (the hold's settings) and d = 500 (phase 20e's)
  and the sweep's cases, each timed parent, this, this, parent; T, probes
  and the swap estimates compared bit for bit.  An earlier tree's kernel
  that takes no full-MVN workspace is called through its own interface
  (:func:`takes_full`).

Needs the card, ``nvcc`` and ``cuobjdump``.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
BUILD = os.path.join(HERE, "scratch_chip", "bench_ladder")
SWEEP_N = (3000, 20000, 50000, 1000000)
SWEEP = dict(tolerance=0.01, seed=1)
HARNESS_N = 3000          # MCMCSimulation's N_samples_swap_est
SASS_LIBS = (("three_mixture", 10), ("mvn_iso", 100))
CTL_BYTES = 256           # the ctl workspace (ladder_build.CTL_WORDS doubles)
# doubles a tile of the sums workspace, the most any tree's kernel takes
# (ladder_build.SUMS_A_TILE; an earlier tree's wrapper may not name it)
SUMS_A_TILE = 19


def csrc_of(path):
    sub = os.path.join(path, "rwm_pt_tpu_torch", "kernels", "csrc")
    return sub if os.path.isdir(sub) else path


def compile_libs(jobs):
    """``jobs``: {tag: (csrc dir, kind, d)} -> {tag: (path, ptxas
    report)}, one nvcc each, all started together."""
    from rwm_pt_tpu_torch.kernels import _build
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for tag, (src, kind, d) in jobs.items():
        out = os.path.join(BUILD, f"lib{tag}.so")
        cmd = [_build._nvcc(), *_build._flags(_build.ladder_lib(kind, d)),
               "-o", out, os.path.join(src, "ladder_build.cu")]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    built, failed = {}, []
    for tag, (p, out) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            failed.append(f"{tag}: nvcc exit {p.returncode}\n{text}")
        built[tag] = (out, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


# the ladder library's C entry points (kernels/_build.py::_ENTRIES), and
# those of an earlier kernel, which takes no full-MVN workspace
_P, _I, _U, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_double)
ENTRIES = {"rwm_pt_ladder_build":
           [_P, _I, _P, _I, _I, _U, _U, _D, _D, _D, _D, _P, _D, _D, _I, _D,
            _I, _I, _I, _P, _P, _P, _P, _P],
           "rwm_pt_ladder_build_info": [_I, _I, _P]}
EARLIER_ENTRIES = {
    "rwm_pt_ladder_build": (ENTRIES["rwm_pt_ladder_build"][:21]
                            + ENTRIES["rwm_pt_ladder_build"][22:]),
    "rwm_pt_ladder_build_info": [_I, _P]}


def takes_full(src):
    """Whether the kernel source in ``src`` takes the full MVN's workspace
    (its entry point's ``full`` argument after ``ctl``, and an info entry
    point of n_params and d); an earlier one takes neither."""
    with open(os.path.join(src, "ladder_build.cu")) as f:
        return "float* full, double* out" in f.read()


class Lib:
    """A compiled ladder library, called through its C entry points (the
    interface of its source, :func:`takes_full`)."""

    def __init__(self, path, full):
        self.path, self.full = path, full
        so = ctypes.CDLL(path)
        entries = ENTRIES if full else EARLIER_ENTRIES
        for fn, argtypes in entries.items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        self.fn = so.rwm_pt_ladder_build
        self.info_fn = so.rwm_pt_ladder_build_info

    def info(self, n_params, d):
        out = (ctypes.c_int * 6)()
        if self.full:
            rc = self.info_fn(n_params, d, out)
        else:
            rc = self.info_fn(4 * n_params if 4 * n_params <= 32 * 1024
                              else 0, out)
        if rc:
            raise RuntimeError(f"{self.path}: info cudaError {rc}")
        return dict(zip(("registers", "local_bytes", "max_threads",
                         "blocks_per_sm", "sms"), list(out)))


class Case:
    """One build's inputs on the card, made once (the wrapper's arithmetic
    of ``launch_ladder_kernel``) and launched through any library."""

    def __init__(self, torch, tg, kind, kw):
        from rwm_pt_tpu_torch.kernels import _build, ladder_build
        from rwm_pt_tpu_torch.kernels.draws import seed_key
        o = dict(target_swap_acceptance_rate=0.234, beta_min=0.01,
                 tolerance=0.005, initial_pn=0.5, pn_update_power=-0.25,
                 max_pn_adjustment_steps=100, pn_clamping_range=(-10., 10.),
                 convergence_failure_tolerance_factor=3.0, seed=0, max_T=24)
        o.update(kw)
        self.torch, self.o, self.d = torch, o, tg.dim
        dev = tg.device
        self.params = _build.kernel_target(tg)[1].to(dev)
        self.sparams = ladder_build.sampler_params(kind, tg).to(dev)
        self.n = int(o["N_samples_swap_est"])
        self.cap = max(1, min(ladder_build.TRACE_MAX,
                              o["max_T"] * o["max_pn_adjustment_steps"]))
        self.tiles = torch.empty(-(-self.n // 256) * SUMS_A_TILE,
                                 dtype=torch.float64, device=dev)
        self.ctl = torch.zeros(CTL_BYTES // 8, dtype=torch.int64,
                               device=dev)
        self.out = torch.empty(2 + o["max_T"] + self.cap,
                               dtype=torch.float64, device=dev)
        self.steps = torch.tensor(
            [nu ** o["pn_update_power"] for nu in
             range(1, max(1, o["max_pn_adjustment_steps"]) + 1)],
            dtype=torch.float64).to(dev)
        self.key = seed_key(o["seed"])
        self.dev = dev
        # (an earlier tree's wrapper, imported by --host-only --tree,
        # takes no full-MVN workspace)
        full_warp = getattr(ladder_build, "full_warp", None)
        self.full = (torch.empty(ladder_build.full_words(tg.dim, self.n),
                                 dtype=torch.float32, device=dev)
                     if full_warp and full_warp(kind, tg.dim) else None)

    def launch(self, lib):
        o, torch = self.o, self.torch
        with torch.cuda.device(self.dev):
            stream = torch.cuda.current_stream(self.dev).cuda_stream
            full = ([None if self.full is None else self.full.data_ptr()]
                    if lib.full else [])
            rc = lib.fn(self.params.data_ptr(), self.params.numel(),
                        self.sparams.data_ptr(), self.d, self.n, *self.key,
                        float(o["target_swap_acceptance_rate"]),
                        float(o["beta_min"]), float(o["tolerance"]),
                        float(o["initial_pn"]), self.steps.data_ptr(),
                        float(o["pn_clamping_range"][0]),
                        float(o["pn_clamping_range"][1]),
                        int(o["max_pn_adjustment_steps"]),
                        float(o["convergence_failure_tolerance_factor"]),
                        int(o["max_T"]), 0, self.cap, self.tiles.data_ptr(),
                        self.ctl.data_ptr(), *full, self.out.data_ptr(),
                        stream)
        if rc:
            raise RuntimeError(f"{lib.path}: launch cudaError {rc}")

    def result(self):
        host = self.out.cpu().tolist()
        T, probes = int(host[0]), int(host[1])
        mt = self.o["max_T"]
        return dict(T=T, probes=probes, betas=host[2:2 + T],
                    a_hats=host[2 + mt:2 + mt + min(probes, self.cap)])

    def time(self, lib, reps):
        """(best device ms over ``reps`` launches after a warm-up, the
        result)."""
        torch = self.torch
        self.launch(lib)
        best = float("inf")
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            self.launch(lib)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        return best, self.result()


def sass_counts(path):
    """Static counts of the library's SASS."""
    from rwm_pt_tpu_torch.kernels import _build
    exe = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", path], capture_output=True,
                          text=True, timeout=300).stdout
    lines = [ln for ln in sass.splitlines()
             if re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", ln)]

    def count(pat):
        return sum(1 for ln in lines if re.search(pat, ln))
    return dict(instructions=len(lines),
                philox_multiplies=count(r"0xd2511f53"),
                mufu=count(r"\bMUFU\b"), ldl=count(r"\bLDL\b"),
                stl=count(r"\bSTL\b"), shfl=count(r"\bSHFL\b"),
                bar=count(r"\bBAR\b"), atom=count(r"\bATOM|\bRED\b"),
                bra=count(r"\bBRA\b"), call=count(r"\bCALL\b"))


def card_name():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        return "nvidia-smi not found"


def fit(points):
    """Least squares of µs a probe on N: (fixed µs, ns a sample)."""
    n = len(points)
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    sxx = sum((x - mx) ** 2 for x, _ in points)
    b = sum((x - mx) * (y - my) for x, y in points) / sxx
    return my - b * mx, 1e3 * b


def host_us(torch, reps, host_reps):
    """{case: (least, median) of the wrapper's host µs a build}: the wall
    time of each of ``host_reps`` calls of ``launch_ladder_kernel``
    (synchronised before; its read of the result synchronises after) less
    the best device time of its library's launch alone on the same inputs
    (``reps`` launches), at the harness's N, for the imported tree's
    wrapper and library."""
    from chip_smoke import LADDER_HOLD, ladder_target
    from rwm_pt_tpu_torch.kernels import _build, ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    from rwm_pt_tpu_torch.targets import get_target_distribution
    dev = torch.device("cuda")
    out = {}
    for kind, d in SASS_LIBS:
        tg = ladder_target(get_target_distribution, kind, d, dev)
        kw = dict(LADDER_HOLD, max_T=L.EAGER_MAX_RUNGS + 1,
                  N_samples_swap_est=HARNESS_N)
        name = _build.ladder_lib(kind, d)
        _build.build([name])
        dev_ms, _ = Case(torch, tg, kind, kw).time(
            Lib(str(_build._lib_path(name)), takes_full(_build.CSRC)), reps)
        ladder_build.launch_ladder_kernel(tg, **kw)
        walls = []
        for _ in range(host_reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ladder_build.launch_ladder_kernel(tg, **kw)
            walls.append(time.perf_counter() - t0)
        host = sorted(1e6 * w - 1e3 * dev_ms for w in walls)
        out[f"{kind}.d{d}.n{HARNESS_N}"] = (host[0], host[len(host) // 2])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--host-only", action="store_true",
                    help="print the wrapper's host µs (one JSON line)")
    ap.add_argument("--tree", help="with --host-only: the checkout whose "
                    "rwm_pt_tpu_torch is imported")
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--host-reps", type=int, default=50,
                    help="timed wrapper calls a case of the host section")
    ap.add_argument("--only", default="",
                    help="run only the cases whose label matches")
    a = ap.parse_args()
    if a.tree:
        sys.path.insert(0, os.path.abspath(a.tree))
    import torch
    if a.host_only:
        print(json.dumps(host_us(torch, a.reps, a.host_reps)))
        return

    from chip_smoke import (LADDER_HOLD, LADDER_KINDS, LADDER_PROD, bound,
                            ladder_target, ladder_work)
    from rwm_pt_tpu_torch.kernels import _build, ladder_build
    from rwm_pt_tpu_torch.ladders import ladders as L
    from rwm_pt_tpu_torch.targets import get_target_distribution

    if not torch.cuda.is_available():
        sys.exit("bench_torch_ladder.py needs a CUDA device")
    dev = torch.device("cuda")
    card = card_name()
    print(f"card {card}; torch {torch.__version__}", flush=True)
    res = dict(card=card, libraries={}, sass={}, sweep={}, stamps={},
               host={}, turns={})
    here = csrc_of(HERE)
    trees = {"this": here}
    if a.parent:
        trees["parent"] = csrc_of(os.path.abspath(a.parent))
    held = dict(LADDER_HOLD, max_T=L.EAGER_MAX_RUNGS + 1)
    room10 = _build.max_rungs(10) + 1

    # the cases: label -> (kind, d, kw)
    cases = {f"hold.{k}": (k, 10, held) for k in LADDER_KINDS}
    cases["hold.mvn_iso.d100"] = ("mvn_iso", 100, held)
    cases["harness.three_mixture.n3000"] = (
        "three_mixture", 10, dict(held, N_samples_swap_est=HARNESS_N,
                                  tolerance=0.005))
    cases["production.three_mixture"] = (
        "three_mixture", 10, dict(LADDER_PROD, max_T=room10))
    # the full MVN's warp form (above the 16 bucket): at d = 30 (the 32
    # bucket) at the holds' settings, and at d = 500 at phase 20e's (N =
    # 3000, beta_min 0.3, tolerance 0.05)
    cases["full.mvn_full.d30"] = ("mvn_full", 30, held)
    cases["full.mvn_full.d500"] = ("mvn_full", 500, dict(
        held, N_samples_swap_est=HARNESS_N, beta_min=0.3, tolerance=0.05))
    for kind, d in (("three_mixture", 10), ("mvn_iso", 100)):
        for n in SWEEP_N:
            cases[f"sweep.{kind}.d{d}.n{n}"] = (
                kind, d, dict(SWEEP, N_samples_swap_est=n,
                              max_T=L.EAGER_MAX_RUNGS + 1))
    cases = {k: v for k, v in cases.items() if re.search(a.only, k)}

    libs = {(kind, d) for kind, d, _ in cases.values()} | set(SASS_LIBS)
    libs |= {(k, 10) for k in LADDER_KINDS} | {("mvn_iso", 100)}
    jobs = {}
    for tree, src in trees.items():
        for kind, d in libs:
            jobs[f"{tree}.{kind}.d{d}"] = (src, kind, d)
    # this tree's measuring builds (ladder_build.probe_split) through
    # _build's cache, beside the rest
    stamped = threading.Thread(target=_build.build, args=(
        [_build.ladder_lib(kind, d, stamps=True) for kind, d in SASS_LIBS],))
    t0 = time.time()
    stamped.start()
    built = compile_libs(jobs)
    stamped.join()
    print(f"built {len(built)} libraries in {time.time() - t0:.1f} s",
          flush=True)
    loaded = {tag: Lib(path, takes_full(trees[tag.split(".")[0]]))
              for tag, (path, _) in built.items()}
    targets = {}

    def target(kind, d):
        if (kind, d) not in targets:
            targets[kind, d] = ladder_target(get_target_distribution, kind,
                                             d, dev)
        return targets[kind, d]

    # ---- registers, local bytes, occupancy
    for tree in trees:
        for kind, d in sorted(libs):
            tg = target(kind, d)
            info = loaded[f"{tree}.{kind}.d{d}"].info(
                _build.kernel_target(tg)[1].numel(), d)
            info["warps_per_sm"] = (info["blocks_per_sm"]
                                    * info["max_threads"] // 32)
            m = re.findall(r"Used (\d+) registers.*?(\d+) bytes cmem",
                           built[f"{tree}.{kind}.d{d}"][1])
            spill = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                               r"stores, (\d+) bytes spill loads",
                               built[f"{tree}.{kind}.d{d}"][1])
            info["stack_spill"] = [list(map(int, s)) for s in spill]
            res["libraries"][f"{tree}.{kind}.d{d}"] = info
            print(f"library {tree} {_build.ladder_lib(kind, d)}: {info}"
                  f"{'' if m else ' (no ptxas register line)'}", flush=True)
    # ---- SASS
    for tree in trees:
        for kind, d in SASS_LIBS:
            c = sass_counts(built[f"{tree}.{kind}.d{d}"][0])
            res["sass"][f"{tree}.{kind}.d{d}"] = c
            print(f"sass {tree} {_build.ladder_lib(kind, d)}: {c}",
                  flush=True)

    made = {}

    def case(label):
        if label not in made:
            kind, d, kw = cases[label]
            made[label] = Case(torch, target(kind, d), kind, kw)
        return made[label]

    # ---- the sweep and the stamps, this tree
    for kind, d in (("three_mixture", 10), ("mvn_iso", 100)):
        pts = []
        for n in SWEEP_N:
            label = f"sweep.{kind}.d{d}.n{n}"
            if label not in cases:
                continue
            c = case(label)
            ms, r = c.time(loaded[f"this.{kind}.d{d}"], a.reps)
            us = 1e3 * ms / r["probes"]
            pts.append((n, us))
            f, ints, nb = ladder_work(kind, d, n, r["probes"])
            b_ms, b_by, _ = bound(f, ints, nb)
            split = ladder_build.probe_split(target(kind, d),
                                             **cases[label][2])
            res["sweep"][label] = dict(ms=ms, probes=r["probes"],
                                       us_a_probe=us, bound_ms=b_ms,
                                       bound_by=b_by, share=b_ms / ms,
                                       stamps_us=split)
            print(f"sweep {label}: {ms:.3f} ms, {r['probes']} probes, "
                  f"{us:.2f} us a probe; bound {b_ms:.4f} ms by {b_by} "
                  f"({100 * b_ms / ms:.1f} %); stamps (us a probe) {split}",
                  flush=True)
        if len(pts) >= 2:
            fixed, slope = fit(pts)
            res["sweep"][f"fit.{kind}.d{d}"] = dict(fixed_us=fixed,
                                                   ns_a_sample=slope)
            print(f"sweep fit {kind} d={d}: {fixed:.2f} us a probe fixed, "
                  f"{slope:.4f} ns a sample", flush=True)

    # ---- the wrapper's host time, this tree's here, then each tree in a
    # process of its own
    got = host_us(torch, a.reps, a.host_reps)
    for k, v in got.items():
        res["host"][f"this.in_process.{k}"] = v
    print(f"host this, in the bench's process (least, median us): {got}",
          flush=True)
    order = ("parent", "this", "this", "parent") if a.parent else ("this",)
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--host-only",
               "--reps", str(a.reps), "--host-reps", str(a.host_reps)]
        if tree == "parent":
            cmd += ["--tree", os.path.abspath(a.parent)]
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if run.returncode:
            raise RuntimeError(f"host run of {tree}: {run.stdout}{run.stderr}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        for k, v in got.items():
            res["host"].setdefault(f"{tree}.{k}", []).append(v)
        print(f"host {tree}, a process of its own (least, median us): "
              f"{got}", flush=True)

    # ---- parent against this, in turns
    if "parent" in trees:
        for label in cases:
            kind, d, _ = cases[label]
            c = case(label)
            order = ("parent", "this", "this", "parent")
            times, outs = {t: [] for t in trees}, {}
            for tree in order:
                ms, r = c.time(loaded[f"{tree}.{kind}.d{d}"], a.reps)
                times[tree].append(ms)
                outs.setdefault(tree, r)
            p, t = outs["parent"], outs["this"]
            equal = (p["T"] == t["T"] and p["probes"] == t["probes"]
                     and p["betas"] == t["betas"]
                     and repr(p["a_hats"]) == repr(t["a_hats"]))
            first = next((i for i, (x, y) in enumerate(
                zip(p["a_hats"], t["a_hats"])) if repr(x) != repr(y)), None)
            same_ladder = (p["T"] == t["T"] and p["probes"] == t["probes"]
                           and all(abs(x - y) <= 1e-5 * abs(y) for x, y in
                                   zip(t["betas"], p["betas"])))
            pm, tm = min(times["parent"]), min(times["this"])
            res["turns"][label] = dict(
                parent_ms=times["parent"], this_ms=times["this"],
                speedup=pm / tm, probes=t["probes"], T=t["T"],
                parent_probes=p["probes"], a_hats_equal=equal,
                first_difference=first, same_ladder=same_ladder,
                parent_us_a_probe=1e3 * pm / p["probes"],
                this_us_a_probe=1e3 * tm / t["probes"])
            print(f"turns {label}: parent {times['parent']} ms, this "
                  f"{times['this']} ms ({pm / tm:.2f}x); us a probe "
                  f"{1e3 * pm / p['probes']:.2f} -> "
                  f"{1e3 * tm / t['probes']:.2f}; T {p['T']} / {t['T']}, "
                  f"probes {p['probes']} / {t['probes']}; a_hats equal bit "
                  f"for bit: {equal} (first difference {first}); same "
                  f"ladder (1e-5): {same_ladder}", flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(dict(card=card, done=True)))


if __name__ == "__main__":
    main()
