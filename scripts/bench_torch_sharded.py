"""What the sharded runs' counter offsets and host path cost on one card.

    python scripts/bench_torch_sharded.py [--tree DIR] [--out FILE]
        [--only main,registers,hybrid]

``--tree`` is a checkout of this repository whose ``rwm_pt_tpu_torch`` is
imported (default: the one holding this script), so that an earlier tree
unpacked with ``git archive`` runs through its own code; run the trees one
after another in one chip call (parent, change, change, parent) to compare
them.  Sections:

* ``main``: the flagship PT (30-d FullRosenbrock, T = 10 rungs 1 .. 0.01,
  variance 0.5^2/30, swap every 100, 65,536 replicas, 2000 steps) and the
  RWM headline (65,536 chains) through ``run_pt_fused`` / ``run_rwm_fused``:
  a warm-up call, then the best of ``--reps`` CUDA-event timings;
* ``registers``: ptxas registers, stack frame and spill bytes of a fixed
  set of fused libraries (the main paths' kinds and proposals, the
  register-tight builds: SuperFunnel's fixed thread and team builds, the
  team buckets, the full MVN, Hypercube), built in the tree's own build
  directory;
* ``hybrid`` (a tree with ``kernels/fused_sharded.py``): the
  temperature-sharded hybrid at the flagship shape on ``temps`` meshes of
  2 and 10 virtual shards of ``cuda:0``: its wall time, the same run with
  a synchronise around each MH segment and each swap event (their split),
  the host time of one segment's ``run_pt_fused`` call with no steps, and
  ``torch.profiler``'s count of stream synchronisations and its device
  time by kernel.

Prints one line a result, the card's name and power limit first, and
writes them as JSON to ``--out``.  Needs the card and ``nvcc``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

D, T, C, STEPS, SWAP = 30, 10, 65536, 2000, 100
VAR = 0.5 ** 2 / 30


def _ms(torch, fn, reps):
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def main_paths(torch, reps):
    from rwm_pt_tpu_torch.kernels import run_pt_fused, run_rwm_fused
    from rwm_pt_tpu_torch.targets import FullRosenbrock
    dev = torch.device("cuda")
    rb = FullRosenbrock.create(D, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)

    def pt():
        return run_pt_fused(rb, 1, betas, base_variance=VAR, num_chains=C,
                            num_iterations=STEPS, swap_every=SWAP,
                            device=dev)

    def rwm():
        return run_rwm_fused(rb, 1, base_variance=VAR, num_chains=C,
                             num_iterations=STEPS, device=dev)
    out = {}
    for name, fn in (("flagship_pt_ms", pt), ("rwm_headline_ms", rwm)):
        fn()
        torch.cuda.synchronize()
        out[name] = _ms(torch, fn, reps)
    return out


def registers():
    from rwm_pt_tpu_torch.kernels import _build, ptxas_report
    from rwm_pt_tpu_torch.targets import get_target_distribution
    lib, var = _build.lib_name, _build.library
    names = []
    for src in ("fused_pt", "fused_rwm"):
        for prop, draw in (("Normal", "lax_erfinv"), ("Laplace", "icdf"),
                           ("UniformRadius", "lax_erfinv")):
            v = var(src, prop, draw)
            names += [lib(v, "rosenbrock", 30), lib(v, "rough_carpet", 20)]
        v = var(src, "Normal", "lax_erfinv")
        names += [lib(v, k, d) for k, d in (
            ("mvn_iso", 30), ("rosenbrock", 100), ("rosenbrock", 200),
            ("mvn_full", 30), ("hypercube", 30), ("mvn_full", 100),
            ("iid_beta", 100))]
        for J, K in ((5, 3), (10, 5), (40, 3)):
            sf = get_target_distribution("SuperFunnel", 0, J=J, K=K,
                                         n_per_group=20, device="cpu")
            names.append(_build.route(v, sf)[0])
    names = list(dict.fromkeys(names))
    t0 = time.time()
    logs = _build.build(names)
    out = {n: sorted(ptxas_report.parse(logs[n])) for n in names}
    return {"build_s": time.time() - t0, "libraries": out}


def hybrid(torch):
    from torch.profiler import ProfilerActivity, profile

    from rwm_pt_tpu_torch.kernels import fused_sharded, run_pt_fused
    from rwm_pt_tpu_torch.parallel import make_mesh
    from rwm_pt_tpu_torch.targets import FullRosenbrock
    dev = torch.device("cuda", 0)
    rb = FullRosenbrock.create(D, device=dev)
    betas = torch.logspace(0, -2, T, device=dev)
    kw = dict(base_variance=VAR, num_chains=C, num_iterations=STEPS,
              swap_every=SWAP)
    run = fused_sharded.run_pt_fused_tempsharded
    out = {}
    for n_t in (2, 10):
        mesh = make_mesh((n_t,), ("temps",), devices=[dev] * n_t)
        run(rb, 0, betas, mesh, **kw)
        torch.cuda.synchronize()
        wall = _ms(torch, lambda: run(rb, 0, betas, mesh, **kw), 1)
        spent = {"segment": [0.0, 0], "event": [0.0, 0]}
        real = (fused_sharded.run_pt_fused,
                fused_sharded._tempsharded_swap_event)

        def timed(name, fn):
            def w(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                spent[name][0] += (time.perf_counter() - t0) * 1e3
                spent[name][1] += 1
                return res
            return w
        fused_sharded.run_pt_fused = timed("segment", real[0])
        fused_sharded._tempsharded_swap_event = timed("event", real[1])
        try:
            split = _ms(torch, lambda: run(rb, 0, betas, mesh, **kw), 1)
        finally:
            (fused_sharded.run_pt_fused,
             fused_sharded._tempsharded_swap_event) = real
        st = run_pt_fused(rb, 0, betas[:T // n_t], base_variance=VAR,
                          num_chains=C, num_iterations=1,
                          swap_every=STEPS + 1, device=dev).state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run_pt_fused(rb, 0, betas[:T // n_t], base_variance=VAR,
                         num_chains=C, num_iterations=0,
                         swap_every=STEPS + 1, resume_state=st, device=dev)
        host = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(rb, 0, betas, mesh, **kw)
            torch.cuda.synchronize()
        ev = prof.key_averages()
        syncs = sum(e.count for e in ev if e.key == "cudaStreamSynchronize")
        dev_ms = {e.key[:60]: e.device_time_total / 1e3 for e in ev
                  if e.device_time_total and not e.key.startswith("aten::")}
        top = dict(sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6])
        out[f"temps_{n_t}"] = dict(
            wall_ms=wall, synchronised_ms=split,
            segments_ms=spent["segment"][0], segments=spent["segment"][1],
            events_ms=spent["event"][0], events=spent["event"][1],
            segment_host_ms=host, stream_syncs=syncs,
            device_ms_by_kernel=top)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="main,registers,hybrid")
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{tree}: {smi}", flush=True)
    res = {"tree": tree, "card": smi}
    only = a.only.split(",")
    if "main" in only:
        res["main"] = main_paths(torch, a.reps)
        print(f"{tree}: {res['main']}", flush=True)
    if "registers" in only:
        res["registers"] = registers()
        print(f"{tree}: {len(res['registers']['libraries'])} libraries "
              f"built in {res['registers']['build_s']:.1f} s", flush=True)
    if ("hybrid" in only and os.path.exists(os.path.join(
            tree, "rwm_pt_tpu_torch", "kernels", "fused_sharded.py"))):
        res["hybrid"] = hybrid(torch)
        for k, v in res["hybrid"].items():
            print(f"{tree}: hybrid {k}: {v}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
