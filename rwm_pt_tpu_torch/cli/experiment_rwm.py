"""RWM proposal-scale study (port of ``rwm_pt_tpu.cli.experiment_rwm``).

    python -m rwm_pt_tpu_torch.cli.experiment_rwm --dim 20 \\
        --target MultivariateNormal --proposal Laplace --num_iters 200000 \\
        --num_chains 1024 --var_max 4.0 --seed 1 --no_plots

Sweeps ``num_configs`` proposal scale parameters over
``linspace(0.01, var_max)`` (the reference: 40), runs ``num_chains`` chains
at each through the fused RWM sampler (one launch of the CUDA kernel per
config on the card), records the acceptance-rate and ESJD curves, reports
the ESJD-optimal point and writes the JAX study's JSON schema, with
``"backend"`` the torch device.  Files are named
``{target}_{proposal}_RWM_GPU_dim{d}_{iters}iters_seed{seed}.json``.

Config ``i`` draws from the Philox seed :func:`config_seed` ``(seed, i)``.
The plots of the optimum (``_make_optimal_plots``) need matplotlib, which
is imported there only; ``--no_plots`` skips them.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..kernels import run_rwm_fused
from ..proposals import create_proposal_distribution
from ..targets import get_target_distribution
from ..utils.dtypes import resolve_device
from .common import (add_run_args, add_target_args, build_proposal_config,
                     resolve_actual_dim, resolve_device_from_args, save_json,
                     target_kwargs_from_args)


def config_seed(seed: int, i: int) -> int:
    """Philox seed of config ``i`` of a study seeded ``seed``:
    ``(seed mod 2^32) * 2^16 + i`` (distinct for the first 65,536 configs
    of every 32-bit seed)."""
    return (int(seed) % (1 << 32)) * (1 << 16) + int(i)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_study(dim, target_name="MultivariateNormal", num_iters=100000,
              var_max=3.5, seed=42, burn_in=1000, proposal_name="Normal",
              proposal_params=None, num_chains=64, num_configs=40,
              output_dir="data", images_dir="images", make_plots=True,
              device="cuda", **kwargs):
    dev = resolve_device(device)
    print("=" * 60)
    print(f"Target: {target_name}, Dimension: {dim}, "
          f"Proposal: {proposal_name}")
    print(f"Samples: {num_iters}, Burn-in: {burn_in}, Seed: {seed}, "
          f"Chains: {num_chains}")
    print("=" * 60)

    target = get_target_distribution(target_name, dim, device=dev, **kwargs)
    actual_dim = target.dim
    scale_param_range = np.linspace(0.01, var_max, num_configs)
    anisotropic = (proposal_params or {}).get("anisotropic")

    acceptance_rates, esjds, times = [], [], []
    _sync(dev)
    total_start = time.time()
    for i, scale in enumerate(scale_param_range):
        cfg = build_proposal_config(proposal_name, float(scale), actual_dim,
                                    anisotropic)
        prop = create_proposal_distribution(actual_dim, cfg, device=dev)
        t0 = time.time()
        res = run_rwm_fused(target, config_seed(seed, i), proposal=prop,
                            num_chains=num_chains, num_iterations=num_iters,
                            burn_in=burn_in, device=dev)
        _sync(dev)
        dt = time.time() - t0
        times.append(dt)
        acceptance_rates.append(float(res.acceptance_rate.mean()))
        esjds.append(float(res.esjd.mean()))
        rate = num_iters * num_chains / dt
        print(f"  [{i + 1}/{num_configs}] scale={scale:.4f} "
              f"acc={acceptance_rates[-1]:.3f} esjd={esjds[-1]:.5f} "
              f"({rate:,.0f} steps/s)")

    total_time = time.time() - total_start
    max_idx = int(np.argmax(esjds))
    max_esjd = esjds[max_idx]
    max_acceptance_rate = acceptance_rates[max_idx]
    max_scale_param = float(scale_param_range[max_idx])

    print("\nFinal Results:")
    print(f"   Total time: {total_time:.1f} seconds")
    print(f"   Maximum ESJD: {max_esjd:.6f}")
    print(f"   Optimal acceptance rate: {max_acceptance_rate:.3f}")
    print(f"   Optimal scale parameter: {max_scale_param:.6f}")

    data = {
        "target_distribution": target_name,
        "proposal_distribution": proposal_name,
        "dimension": actual_dim,
        "num_iterations": num_iters,
        "seed": seed,
        "total_time": total_time,
        "max_esjd": max_esjd,
        "max_acceptance_rate": max_acceptance_rate,
        "max_scale_param": max_scale_param,
        "expected_squared_jump_distances": esjds,
        "acceptance_rates": acceptance_rates,
        "scale_param_range": scale_param_range.tolist(),
        "times": times,
        "num_chains": num_chains,
        "backend": str(dev),
        "mh_steps_per_sec": num_iters * num_chains * num_configs / total_time,
    }
    filename = (f"{output_dir}/{target_name}_{proposal_name}_RWM_GPU_"
                f"dim{actual_dim}_{num_iters}iters_seed{seed}.json")
    save_json(data, filename)

    if make_plots:
        _make_optimal_plots(target, target_name, proposal_name,
                            max_scale_param, max_acceptance_rate, actual_dim,
                            num_iters, burn_in, seed, anisotropic, images_dir,
                            dev)
    return data


def _make_optimal_plots(target, target_name, proposal_name, max_scale_param,
                        max_acceptance_rate, actual_dim, num_iters, burn_in,
                        seed, anisotropic, images_dir, dev):
    """Traceplot and 2-D density overlay at the ESJD-optimal scale, from
    the trace of a recorded fused run."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = build_proposal_config(proposal_name, max_scale_param, actual_dim,
                                anisotropic)
    prop = create_proposal_distribution(actual_dim, cfg, device=dev)
    n_plot = min(num_iters, 100000)
    rec = max(1, (n_plot + burn_in) // 100000)
    res = run_rwm_fused(target, seed, proposal=prop, num_chains=8,
                        num_iterations=n_plot, burn_in=burn_in,
                        record_every=rec, record_chains=1, device=dev)
    chain = res.chain.cpu().numpy()[..., 0]      # (n_rec, d)
    chain = chain[burn_in // rec:]
    os.makedirs(images_dir, exist_ok=True)

    ndp = min(3, actual_dim)
    plt.figure(figsize=(12, 8))
    for i in range(ndp):
        plt.subplot(ndp, 1, i + 1)
        plt.plot(chain[:, i], alpha=0.7, linewidth=0.5, color=f"C{i}")
        plt.ylabel(f"Dimension {i + 1}")
        plt.grid(True, alpha=0.3)
        if i == 0:
            plt.title(f"Traceplot - {target_name} (First {ndp} dimensions)\n"
                      f"Optimal scale parameter: {max_scale_param:.6f}, "
                      f"Acceptance rate: {max_acceptance_rate:.3f}")
    plt.xlabel("Iteration")
    plt.tight_layout()
    out = (f"{images_dir}/traceplot_{target_name}_{proposal_name}_RWM_GPU_"
           f"dim{actual_dim}_{num_iters}iters_seed{seed}.png")
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close()
    print(f"   Traceplot created and saved as '{out}'")

    if actual_dim >= 2:
        x_chain, y_chain = chain[:, 0], chain[:, 1]
        pad = 0.02
        xr = x_chain.max() - x_chain.min()
        yr = y_chain.max() - y_chain.min()
        xg = np.linspace(x_chain.min() - pad * xr, x_chain.max() + pad * xr,
                         100)
        yg = np.linspace(y_chain.min() - pad * yr, y_chain.max() + pad * yr,
                         100)
        X, Y = np.meshgrid(xg, yg)
        pts = np.zeros((X.size, actual_dim), np.float32)
        pts[:, 0] = X.ravel()
        pts[:, 1] = Y.ravel()
        if actual_dim > 2:
            pts[:, 2:] = chain[:, 2:].mean(0)
        Z = target.density(torch.as_tensor(pts, device=dev)).cpu().numpy() \
            .reshape(X.shape)
        plt.figure(figsize=(10, 8))
        plt.contourf(X, Y, Z, levels=20, cmap="Greys", alpha=0.7)
        plt.colorbar(label="Target Density")
        plt.contour(X, Y, Z, levels=10, colors="white", alpha=0.3,
                    linewidths=0.5)
        n_traj = max(1, int(0.05 * len(x_chain)))
        idx = np.linspace(0, len(x_chain) - 1, n_traj, dtype=int)
        step = max(1, len(idx) // 200)
        plt.scatter(x_chain[idx][::step], y_chain[idx][::step], c="red", s=3,
                    alpha=0.6, zorder=5, label="MCMC Samples")
        plt.xlabel("Dimension 1")
        plt.ylabel("Dimension 2")
        plt.title(f"2D Target Density with MCMC Samples - {target_name}\n"
                  f"Optimal scale parameter: {max_scale_param:.6f}, "
                  f"Acceptance rate: {max_acceptance_rate:.3f}")
        plt.grid(True, alpha=0.3)
        out2 = (f"{images_dir}/density2D_{target_name}_{proposal_name}_"
                f"RWM_GPU_dim{actual_dim}_{num_iters}iters_seed{seed}.png")
        plt.savefig(out2, dpi=150, bbox_inches="tight")
        plt.close()
        print(f"   2D density visualization created and saved as '{out2}'")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="RWM simulations on one NVIDIA GPU with flexible "
                    "proposal distributions")
    add_target_args(parser)
    add_run_args(parser, default_iters=100000)
    parser.add_argument("--var_max", type=float, default=3.5,
                        help="Maximum scale parameter value")
    parser.add_argument("--num_configs", type=int, default=40,
                        help="Number of scale parameters in the sweep "
                             "(reference: 40)")
    parser.add_argument("--proposal", type=str, default="Normal",
                        choices=["Normal", "Laplace", "UniformRadius"])
    parser.add_argument("--laplace_anisotropic", type=str, default=None,
                        help="JSON list for anisotropic Laplace variance vector")
    parser.add_argument("--no_plots", action="store_true")
    args = parser.parse_args(argv)
    device = resolve_device_from_args(args)

    proposal_params = {}
    if args.proposal == "Laplace" and args.laplace_anisotropic:
        try:
            proposal_params["anisotropic"] = json.loads(args.laplace_anisotropic)
        except json.JSONDecodeError:
            print("Invalid JSON for laplace_anisotropic. Using isotropic Laplace.")

    dim = resolve_actual_dim(args)
    data = run_study(dim, args.target, args.num_iters, args.var_max, args.seed,
                     args.burn_in, args.proposal, proposal_params,
                     num_chains=args.num_chains, num_configs=args.num_configs,
                     output_dir=args.output_dir, images_dir=args.images_dir,
                     make_plots=not args.no_plots, device=device,
                     **target_kwargs_from_args(args))
    print(f"Finished running experiment with {args.proposal} proposal.")
    return data


if __name__ == "__main__":
    main()
