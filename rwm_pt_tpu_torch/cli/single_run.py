"""Single-configuration run with the plot suite (port of
``rwm_pt_tpu.cli.single_run``).

    python -m rwm_pt_tpu_torch.cli.single_run --dim 10 \\
        --target MultivariateNormal --algorithm PT --num_chains 65536 \\
        --burn_in 3000 --num_iters 2000 --autotune --no_plots

One RWM or PT run of ``MCMCSimulation`` at one proposal scale, with trace
plots, the target-density histogram and marginal histograms, and a summary
JSON with the JAX CLI's keys, named
``{target}_single_run_{algorithm}_dim{d}_{iters}iters_seed{seed}.json``.
``--autotune`` tunes the proposal scale to 0.234 acceptance during burn-in
instead of using ``--scale_param`` as it is (no trace, so no plots; the
JSON gains the tuned multiplier and ``tuned_proposal_config``);
``--diagnostics M`` records M replicas and reports split R-hat, ESS and
MCSE.  The run takes the harness's ``'auto'`` engine: the fused kernels on
the card (their plain versions with ``--cpu``), the adaptive engine for
``--autotune``.  The plots import matplotlib only when they are drawn;
``--no_plots`` skips them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .common import (add_run_args, add_target_args, build_proposal_config,
                     resolve_actual_dim, resolve_device_from_args, save_json,
                     target_kwargs_from_args)


def run_single_simulation(dim, target_name, num_iters, scale_param, seed,
                          burn_in, proposal_name="Normal", algorithm="RWM",
                          num_chains=8, swap_every=100, output_dir="data",
                          images_dir="images", make_plots=True,
                          use_mesh=False, rng_impl="threefry2x32",
                          autotune=False, diagnostics=0, device="cuda",
                          **kwargs):
    from ..api import MCMCSimulation
    from ..targets import get_target_distribution
    from ..utils.dtypes import resolve_device

    dev = resolve_device(device)
    # the reference's single-run script builds the target classes with their
    # own defaults (multimodal centers +-5): the "class" variant
    kwargs.setdefault("variant", "class")
    target = get_target_distribution(target_name, dim, device=dev, **kwargs)
    actual_dim = target.dim
    cfg = build_proposal_config(proposal_name, scale_param, actual_dim)

    if diagnostics and autotune:
        raise ValueError("--diagnostics needs chain recording, which "
                         "--autotune disables")
    sim = MCMCSimulation(dim=actual_dim, proposal_config=cfg,
                         num_iterations=num_iters,
                         algorithm=algorithm, target_dist=target, seed=seed,
                         burn_in=burn_in, num_chains=num_chains,
                         swap_every=swap_every,
                         geom_temp_spacing=(algorithm.upper() == "PT"),
                         record_chain=True if diagnostics else not autotune,
                         record_chains=max(1, diagnostics),
                         use_mesh=use_mesh, rng_impl=rng_impl,
                         autotune=autotune, device=dev)
    t0 = time.time()
    chain = sim.generate_samples()
    elapsed = time.time() - t0

    data = {
        "target_distribution": target_name,
        "proposal_distribution": proposal_name,
        "algorithm": sim.algorithm_name,
        "dimension": actual_dim,
        "num_iterations": num_iters,
        "scale_param": scale_param,
        "seed": seed,
        "total_time": elapsed,
        "acceptance_rate": sim.acceptance_rate(),
        "esjd": sim.expected_squared_jump_distance(),
        "num_chains": num_chains,
    }
    if sim.is_pt:
        data["pt_esjd"] = sim.pt_expected_squared_jump_distance()
        data["beta_ladder"] = list(map(float, sim.beta_ladder))
    if diagnostics:
        data["split_rhat"] = [float(v) for v in sim.split_rhat()]
        data["ess"] = [float(v) for v in sim.effective_sample_size()]
        data["mcse_mean"] = [float(v) for v in sim.mcse_mean()]
        print(f"   split-R-hat max={max(data['split_rhat']):.4f}  "
              f"ESS min={min(data['ess']):.0f}  "
              f"MCSE max={max(data['mcse_mean']):.2e}")
    if autotune:
        info = sim.get_diagnostic_info()
        data["autotune_target"] = info["autotune_target"]
        data["tuned_scale_multiplier"] = info["tuned_scale_multiplier"]
        data["tuned_proposal_config"] = sim.tuned_proposal_config()
        print(f"   Tuned proposal config: {data['tuned_proposal_config']}")

    filename = (f"{output_dir}/{target_name}_single_run_{sim.algorithm_name}_"
                f"dim{actual_dim}_{num_iters}iters_seed{seed}.json")
    save_json(data, filename)

    if make_plots and chain is not None:
        _plots(sim, chain, target_name, actual_dim, num_iters, seed,
               images_dir)
    print(f"acceptance_rate={data['acceptance_rate']:.4f} "
          f"esjd={data['esjd']:.6f} time={elapsed:.2f}s")
    return data


def _plots(sim, chain, target_name, actual_dim, num_iters, seed,
           images_dir):
    """Trace plot, target-density histogram and the marginal histograms of
    the first <= 4 coordinates with the exact marginal where the target
    has one (needs matplotlib, imported here)."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    os.makedirs(images_dir, exist_ok=True)
    sim.traceplot(output_dir=images_dir)
    sim.samples_histogram(output_dir=images_dir)
    ndp = min(4, actual_dim)
    fig, axes = plt.subplots(1, ndp, figsize=(4 * ndp, 4))
    axes = np.atleast_1d(axes)
    for i in range(ndp):
        axes[i].hist(chain[:, i], bins=60, density=True, alpha=0.6)
        xs = np.linspace(chain[:, i].min() - 1, chain[:, i].max() + 1, 400)
        ys = sim.target_dist.marginal_density(i, xs)
        if ys is not None:
            axes[i].plot(xs, ys.cpu().numpy(), "r--", lw=1.5)
        axes[i].set_title(f"dim {i + 1}")
    fig.suptitle(f"Marginals - {target_name} ({sim.algorithm_name})")
    out = (f"{images_dir}/marginals_{target_name}_{sim.algorithm_name}_"
           f"dim{actual_dim}_{num_iters}iters_seed{seed}.png")
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"   Marginals saved as '{out}'")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Single MCMC run on one NVIDIA GPU with plots")
    add_target_args(parser)
    add_run_args(parser, default_iters=100000)
    parser.add_argument("--proposal", type=str, default="Normal",
                        choices=["Normal", "Laplace", "UniformRadius"])
    parser.add_argument("--scale_param", type=float, default=2.38)
    parser.add_argument("--algorithm", type=str, default="RWM",
                        choices=["RWM", "PT"])
    parser.add_argument("--swap_every", type=int, default=100)
    parser.add_argument("--no_plots", action="store_true")
    parser.add_argument("--autotune", action="store_true",
                        help="tune the proposal scale to the 0.234-optimal "
                             "acceptance during burn-in instead of using "
                             "--scale_param as-is (disables chain recording/"
                             "plots; needs --burn_in of a few thousand)")
    parser.add_argument("--diagnostics", type=int, default=0, metavar="M",
                        help="record M replicas' traces and report split-"
                             "R-hat / ESS / MCSE per dimension (M >= 4 "
                             "recommended)")
    args = parser.parse_args(argv)
    device = resolve_device_from_args(args)

    dim = resolve_actual_dim(args)
    return run_single_simulation(
        dim, args.target, args.num_iters, args.scale_param, args.seed,
        args.burn_in, args.proposal, args.algorithm,
        num_chains=args.num_chains, swap_every=args.swap_every,
        output_dir=args.output_dir, images_dir=args.images_dir,
        make_plots=not args.no_plots and not args.autotune,
        use_mesh=args.use_mesh, rng_impl=args.rng, autotune=args.autotune,
        diagnostics=args.diagnostics, device=device,
        **target_kwargs_from_args(args))


if __name__ == "__main__":
    main()
