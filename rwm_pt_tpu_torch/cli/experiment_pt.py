"""PT swap-acceptance-rate study (port of ``rwm_pt_tpu.cli.experiment_pt``).

    python -m rwm_pt_tpu_torch.cli.experiment_pt --target ThreeMixture \\
        --dim 10 --num_iters 200000 --burn_in 1000 --num_chains 1024 \\
        --swap_accept_max 0.5 --N_samples_swap_est 1000000 \\
        --iterative_tolerance 0.0001 --iterative_max_pn_steps 1000 \\
        --iterative_fail_tol_factor 1 --seed 1 --no_plots

Sweeps ``num_configs`` target swap acceptance rates over
``linspace(0.01, swap_accept_max)`` (the reference: 30).  For each, it
builds an iterative ladder for that rate (seed ``seed + i``; the geometric
ladder with ``--geom_ladder``) with the one-program builder
(``construct_iterative_ladder_device``: one launch of the ladder kernel
on the card, the host loop's ladder), runs ``num_chains`` PT replicas with the
Normal proposal of variance ``2.38^2 / d`` through the fused PT sampler
(one launch of the CUDA kernel per config on the card, with the JAX scan
engine's even/odd swap order, Philox seed :func:`config_seed` ``(seed,
i)``), records the actual swap acceptance and the beta-space ESJD, reports
the ESJD-optimal point and writes the JAX study's JSON schema, with
``"backend"`` the torch device.  Files are named
``{target}_PT_GPU_dim{d}_{iters}iters_seed{seed}.json``.

The iterative builder runs with room for the fused kernel's ``max_rungs``
rungs (under ``--x64``, :data:`~rwm_pt_tpu_torch.ladders.ladders.
EAGER_MAX_RUNGS`), so it lands the host loop's uncapped ladder; a ladder
that needs more rungs raises, as does a longer geometric one: nothing
falls back to the eager engine.  Under ``--x64`` the runs take the eager engine in
float64 (the same even/odd swap order).  ``--use_mesh`` shards the
replicas over a mesh of every visible card (``run_pt_fused_sharded``),
with the JSON of the unsharded run.  ``--rng`` is accepted and changes nothing (the
sampler draws Philox4x32-10).  The plot needs matplotlib, imported there
only; ``--no_plots`` skips it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..kernels import _build, run_pt, run_pt_fused, run_pt_fused_sharded
from ..ladders import (construct_geometric_ladder,
                       construct_iterative_ladder_device)
from ..ladders.ladders import EAGER_MAX_RUNGS, check_room
from ..proposals import NormalProposal
from ..targets import get_target_distribution
from ..utils.dtypes import default_float, resolve_device
from .common import (add_run_args, add_target_args, make_cli_mesh,
                     resolve_actual_dim, resolve_device_from_args, save_json,
                     target_kwargs_from_args)
from .experiment_rwm import _sync, config_seed


def run_study(dim, target_name="ThreeMixture", num_iters=200000,
              swap_accept_max=0.5, seed=42, burn_in=1000,
              N_samples_swap_est=50000, iterative_tolerance=0.0005,
              iterative_max_pn_steps=500, iterative_fail_tol_factor=1.5,
              num_chains=64, num_configs=30, swap_every=100,
              geom_ladder=False, output_dir="data", images_dir="images",
              make_plots=True, use_mesh=False, device="cuda", **kwargs):
    dev = resolve_device(device)
    print("=" * 60)
    print(f"Target: {target_name}, Dimension: {dim}, Samples: {num_iters}, "
          f"Burn-in: {burn_in}, Seed: {seed}, Chains: {num_chains}")
    print("=" * 60)

    # the reference's PT sweep data come from its PT factory (multimodal
    # centers +-15): the "pt_gpu" variant of the registry
    kwargs.setdefault("variant", "pt_gpu")
    target = get_target_distribution(target_name, dim, device=dev, **kwargs)
    actual_dim = target.dim
    swap_rates_range = np.linspace(0.01, swap_accept_max, num_configs)
    proposal_variance = (2.38 ** 2) / actual_dim
    mesh = make_cli_mesh(dev, num_chains) if use_mesh else None

    acceptance_rates, esjds, times, ladder_sizes = [], [], [], []
    _sync(dev)
    total_start = time.time()
    # the fused kernel's rungs; the eager engine (--x64) takes any ladder
    fit = (_build.target_rungs_fit(target)
           if default_float() == torch.float32 else
           _build.RungsFit(EAGER_MAX_RUNGS, "the eager engine"))
    rungs = fit.rungs
    for i, target_rate in enumerate(swap_rates_range):
        t0 = time.time()
        if geom_ladder:
            ladder = construct_geometric_ladder()
        else:
            ladder = check_room(construct_iterative_ladder_device(
                target,
                target_swap_acceptance_rate=float(target_rate),
                N_samples_swap_est=N_samples_swap_est,
                tolerance=iterative_tolerance,
                max_pn_adjustment_steps=iterative_max_pn_steps,
                convergence_failure_tolerance_factor=iterative_fail_tol_factor,
                seed=seed + i, max_T=rungs + 1), rungs, layout=fit.layout)
        run_kw = dict(num_chains=num_chains, num_iterations=num_iters,
                      burn_in=burn_in, swap_every=swap_every,
                      swap_sweep="even_odd", device=dev)
        if default_float() == torch.float64:
            res = run_pt(target, NormalProposal.create(
                actual_dim, proposal_variance, device=dev),
                config_seed(seed, i),
                torch.tensor(ladder, dtype=torch.float64), **run_kw)
        else:
            if len(ladder) > rungs:
                raise NotImplementedError(
                    f"config {i}: the ladder has {len(ladder)} rungs; the "
                    f"fused PT kernel runs at most {rungs} ({fit.layout})")
            betas = torch.tensor(ladder, dtype=torch.float32)
            if mesh is None:
                res = run_pt_fused(target, config_seed(seed, i), betas,
                                   base_variance=proposal_variance, **run_kw)
            else:
                run_kw.pop("device")
                res = run_pt_fused_sharded(
                    target, config_seed(seed, i), betas, mesh,
                    base_variance=proposal_variance, **run_kw)
        _sync(dev)
        dt = time.time() - t0
        times.append(dt)
        ladder_sizes.append(len(ladder))
        acceptance_rates.append(float(res.swap_acceptance_rate.mean()))
        esjds.append(float(res.pt_esjd.mean()))
        rate = num_iters * num_chains * len(ladder) / dt
        print(f"  [{i + 1}/{num_configs}] constr_rate={target_rate:.4f} "
              f"T={len(ladder)} actual={acceptance_rates[-1]:.3f} "
              f"beta-esjd={esjds[-1]:.6f} ({rate:,.0f} MH steps/s)")

    total_time = time.time() - total_start
    max_idx = int(np.argmax(esjds))
    data = {
        "target_distribution": target_name,
        "dimension": actual_dim,
        "num_iterations": num_iters,
        "seed": seed,
        "total_time": total_time,
        "max_esjd": esjds[max_idx],
        "max_actual_acceptance_rate": acceptance_rates[max_idx],
        "max_constr_acceptance_rate": float(swap_rates_range[max_idx]),
        "expected_squared_jump_distances": esjds,
        "acceptance_rates": acceptance_rates,
        "swap_acceptance_rates_range": swap_rates_range.tolist(),
        "times": times,
        "num_chains": num_chains,
        "ladder_sizes": ladder_sizes,
        "backend": str(dev),
    }
    print("\nFinal Results:")
    print(f"   Total time: {total_time:.1f} seconds")
    print(f"   Maximum ESJD: {data['max_esjd']:.6f}")
    print(f"   (Actual) swap acceptance rate at max ESJD: "
          f"{data['max_actual_acceptance_rate']:.3f}")
    print(f"   (Construction) swap acceptance rate at max ESJD: "
          f"{data['max_constr_acceptance_rate']:.3f}")

    filename = (f"{output_dir}/{target_name}_PT_GPU_dim{actual_dim}_"
                f"{num_iters}iters_seed{seed}.json")
    save_json(data, filename)

    if make_plots:
        _plot(acceptance_rates, esjds, target_name, actual_dim, num_iters,
              seed, images_dir)
    return data


def _plot(acceptance_rates, esjds, target_name, actual_dim, num_iters, seed,
          images_dir):
    """Beta-space ESJD against the actual swap acceptance rate."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(images_dir, exist_ok=True)
    plt.plot(acceptance_rates, esjds, marker="x")
    plt.axvline(x=0.234, color="red", linestyle=":", label="a = 0.234")
    plt.xlabel("swap acceptance rate")
    plt.ylabel("beta-space ESJD")
    plt.title(f"PT ESJD vs swap acceptance ({target_name}, "
              f"dim={actual_dim})")
    plt.legend()
    out = (f"{images_dir}/pt_esjd_{target_name}_PT_GPU_dim{actual_dim}_"
           f"{num_iters}iters_seed{seed}.png")
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close()
    print(f"   Plot saved as '{out}'")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Parallel Tempering swap-rate study on one NVIDIA GPU")
    add_target_args(parser)
    add_run_args(parser, default_iters=200000)
    parser.add_argument("--swap_accept_max", type=float, default=0.5)
    parser.add_argument("--num_configs", type=int, default=30,
                        help="Number of swap-rate sweep points (reference: "
                             "30)")
    parser.add_argument("--swap_every", type=int, default=100)
    parser.add_argument("--geom_ladder", action="store_true",
                        help="Use the geometric ladder instead of iterative "
                             "construction")
    parser.add_argument("--N_samples_swap_est", type=int, default=50000)
    parser.add_argument("--iterative_tolerance", type=float, default=0.0005)
    parser.add_argument("--iterative_max_pn_steps", type=int, default=500)
    parser.add_argument("--iterative_fail_tol_factor", type=float,
                        default=1.5)
    parser.add_argument("--no_plots", action="store_true")
    args = parser.parse_args(argv)
    device = resolve_device_from_args(args)

    dim = resolve_actual_dim(args)
    data = run_study(dim, args.target, args.num_iters, args.swap_accept_max,
                     args.seed, args.burn_in, args.N_samples_swap_est,
                     args.iterative_tolerance, args.iterative_max_pn_steps,
                     args.iterative_fail_tol_factor,
                     num_chains=args.num_chains,
                     num_configs=args.num_configs,
                     swap_every=args.swap_every,
                     geom_ladder=args.geom_ladder,
                     output_dir=args.output_dir, images_dir=args.images_dir,
                     make_plots=not args.no_plots, use_mesh=args.use_mesh,
                     device=device, **target_kwargs_from_args(args))
    print("Finished running parallel tempering experiment.")
    return data


if __name__ == "__main__":
    main()
