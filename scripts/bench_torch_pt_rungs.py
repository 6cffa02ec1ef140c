"""Time the port's fused PT kernel where its launch geometry departs from
the flagship's 32 replicas a block: ladders of more than 10 rungs, the
full-covariance MVN, Hypercube and the PT study's 1024 replicas.

    python scripts/bench_torch_pt_rungs.py [--tree DIR] [--out FILE]
                                           [--reps N] [--only REGEX]

``--tree`` is a checkout of this repository whose ``rwm_pt_tpu_torch`` is
imported (default: the one holding this script), so that an earlier tree
unpacked with ``git archive`` is timed through its own code; run the
trees one after another on the same card to compare them.
Each case launches ``kernels/fused_pt.py::launch_pt_kernel`` (d = 30
unless stated, 65,536 replicas, 2000 steps, rungs 1 .. 0.01 geometric,
swap every 100) with each listed normal draw: a warm-up launch, then the
best of ``--reps`` CUDA-event timings.  Prints one line a case (ms, mean
acceptance, swaps a replica, and where the tree has it the launch
geometry and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``'s blocks)
and writes them as JSON to ``--out``; ``--only`` runs the cases whose
target kind matches (``mvn_full``: the full-covariance MVN alone, with the
rule's ``lax_erfinv`` and Box-Muller, for a bisect over trees).  Needs the
card and ``nvcc``.
"""
import argparse
import json
import math
import os
import re
import sys

D, C, STEPS, SWAP = 30, 65536, 2000, 100


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default="",
                    help="run the cases whose target kind matches")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import numpy as np
    import torch

    from rwm_pt_tpu_torch.kernels import _build, fused_pt
    from rwm_pt_tpu_torch.kernels.draws import seed_key
    from rwm_pt_tpu_torch.targets import get_target_distribution

    dev = torch.device("cuda")
    cov = np.random.default_rng(3).normal(size=(D, D))
    targets = {
        "rosenbrock": get_target_distribution("FullRosenbrock", D,
                                              device=dev),
        "rough_carpet": get_target_distribution("RoughCarpet", D,
                                                device=dev),
        "mvn_full": get_target_distribution(
            "MultivariateNormal", D, device=dev,
            cov=cov @ cov.T / D + np.eye(D)),
        "hypercube": get_target_distribution("Hypercube", D, device=dev),
        "three_mixture": get_target_distribution("ThreeMixture", 10,
                                                 device=dev, variant="pt_gpu"),
    }
    bl = ("bm", "lax_erfinv")
    # (target, rungs, replicas, steps, Normal variance, draws)
    cases = [("rosenbrock", T, C, STEPS, 0.5 ** 2 / D, bl)
             for T in (10, 11, 15, 17)]
    cases += [("rough_carpet", 15, C, STEPS, 0.25 * 2.38 ** 2 / D, bl),
              ("mvn_full", 10, C, STEPS, 1.5 * 2.38 ** 2 / D,
               ("icdf",) + bl),
              ("hypercube", 10, C, STEPS, 2.38 ** 2 / 3 / D, bl),
              ("three_mixture", 7, 1024, 20000, 2.38 ** 2 / 10, bl)]
    cases = [c for c in cases if re.search(a.only, c[0])]
    if a.only:
        cases = [c[:5] + (bl,) for c in cases]
    lib = {(k, dr): _build.lib_name(_build.library("fused_pt", "Normal", dr),
                                    k, targets[k].dim)
           for k, *_, drs in cases for dr in drs}
    _build.build(sorted(set(lib.values())))

    g = torch.Generator(device=dev).manual_seed(5)
    res = {"tree": os.path.abspath(a.tree),
           "card": torch.cuda.get_device_name(0), "cases": {}}
    for k, T, cc, steps, var, drs in cases:
        t = targets[k]
        d = t.dim
        betas = torch.logspace(0, -2, T, device=dev)
        sig = torch.sqrt(torch.tensor(var, device=dev) / betas)
        x0 = t.init_sample(cc, g).T[:, None].expand(d, T, cc).contiguous()
        zi = torch.zeros(T, cc, dtype=torch.int32, device=dev)
        args = (t, x0, zi, zi[0].clone(), torch.zeros(cc, device=dev),
                torch.zeros(cc, device=dev), betas, sig, seed_key(3), 0,
                steps, 0, SWAP)
        n_params = _build.kernel_target(t)[1].numel()
        for dr in drs:
            key = f"{k}.d{d}.T{T}.C{cc}.{dr}"
            row = {}
            if hasattr(_build, "launch_geometry"):
                geo = _build.launch_geometry(lib[(k, dr)], d, cc, T, "Normal",
                                             dr, n_params)
                info = _build.kernel_info(lib[(k, dr)], d, T, geo.replicas,
                                          n_params, runtime_r=geo.runtime_r)
                row.update(replicas=geo.replicas, runtime_r=geo.runtime_r,
                           registers=info["registers"],
                           blocks_per_sm=info["blocks_per_sm"])
            fused_pt.launch_pt_kernel(*args, draw=dr)
            torch.cuda.synchronize()
            best, out = math.inf, None
            for _ in range(a.reps):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fused_pt.launch_pt_kernel(*args, draw=dr)
                e1.record()
                torch.cuda.synchronize()
                best = min(best, e0.elapsed_time(e1))
            row.update(ms=best,
                       acc=out[2].float().mean().item() / steps,
                       swaps=out[3].float().mean().item())
            res["cases"][key] = row
            print(key, json.dumps(row), flush=True)
        del x0, args
        torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
