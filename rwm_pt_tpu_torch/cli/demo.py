"""A short walkthrough (port of ``rwm_pt_tpu.cli.demo``): one RWM run and
two PT runs on small targets through ``MCMCSimulation``, with printed
diagnostics and plots.

    python -m rwm_pt_tpu_torch.cli.demo [--cpu] [--num_iters N] [--no_plots]

On the card by default: the fused kernels run the three scenarios, and
scenario 3 builds its 0.234-tuned ladder with the one-program builder (one
launch of the ladder kernel).  ``--cpu`` runs them on the CPU through the
plain versions.  The plots (``traceplot``, ``samples_histogram``, under
``images/``) import matplotlib when called; ``--no_plots`` skips them (a
machine without matplotlib).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="rwm_pt_tpu_torch demo")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (the plain versions)")
    parser.add_argument("--num_iters", type=int, default=20000)
    parser.add_argument("--no_plots", action="store_true",
                        help="Skip scenario 1's plots")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ..api import MCMCSimulation

    print("=== Scenario 1: RWM on a 2-d Gaussian ===")
    sim = MCMCSimulation(dim=2, sigma=2.38 ** 2 / 2,
                         num_iterations=args.num_iters, algorithm="RWM",
                         target_dist="MultivariateNormal", seed=0,
                         burn_in=1000, num_chains=8, device=device)
    sim.generate_samples()
    print(f"acceptance rate: {sim.acceptance_rate():.3f}")
    print(f"ESJD:            {sim.expected_squared_jump_distance():.4f}")
    if not args.no_plots:
        sim.traceplot()
        sim.samples_histogram()

    print("\n=== Scenario 2: PT-RWM on a 2-d trimodal mixture ===")
    sim2 = MCMCSimulation(dim=2, sigma=2.38 ** 2 / 2,
                          num_iterations=args.num_iters, algorithm="PT",
                          target_dist="ThreeMixture", seed=0, burn_in=1000,
                          num_chains=8, swap_every=10, geom_temp_spacing=True,
                          device=device)
    sim2.generate_samples()
    print(f"beta ladder:        {[round(b, 4) for b in sim2.beta_ladder]}")
    print(f"swap acceptance:    {sim2.swap_acceptance_rate():.3f}")
    print(f"beta-space PT ESJD: {sim2.pt_expected_squared_jump_distance():.5f}")
    print(f"cold-chain ESJD:    {sim2.expected_squared_jump_distance():.4f}")

    print("\n=== Scenario 3: PT with an iterative 0.234-tuned ladder ===")
    sim3 = MCMCSimulation(dim=5, sigma=2.38 ** 2 / 5,
                          num_iterations=args.num_iters, algorithm="PT",
                          target_dist="MultivariateNormal", seed=0,
                          burn_in=1000, num_chains=8, swap_every=10,
                          iterative_temp_spacing=True,
                          swap_acceptance_rate=0.234,
                          N_samples_swap_est=5000, iterative_tolerance=0.01,
                          device=device)
    sim3.generate_samples()
    print(f"beta ladder:     {[round(b, 4) for b in sim3.beta_ladder]}")
    print(f"swap acceptance: {sim3.swap_acceptance_rate():.3f} (target 0.234)")
    return sim, sim2, sim3


if __name__ == "__main__":
    main()
