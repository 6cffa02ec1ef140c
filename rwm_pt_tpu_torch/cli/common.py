"""Shared CLI plumbing (port of ``rwm_pt_tpu.cli.common``).

The JAX CLIs' argument surface: target selection with per-target
hyperparameters, run arguments, the scale-parameter -> proposal-config
mapping of the reference sweep, and JSON output.  ``--cpu`` runs on the
CPU (``device="cpu"``, the fused samplers' plain PyTorch versions);
otherwise the card.  ``--use_mesh``, ``--multihost`` and ``--x64`` are
accepted by the parser and raise in :func:`resolve_device_from_args`: the
port runs one process on one card in float32 (ROADMAP Queue A items 13
and 7).
"""
from __future__ import annotations

import argparse
import json
import os

from ..targets.registry import PORTED_TARGETS


def add_target_args(parser: argparse.ArgumentParser):
    parser.add_argument("--dim", type=int, default=20,
                        help="Dimension of the target distribution")
    parser.add_argument("--target", type=str, default="MultivariateNormal",
                        help="Target distribution")
    parser.add_argument("--hybrid_rosenbrock_n1", type=int, default=3,
                        help="Block length parameter for HybridRosenbrock")
    parser.add_argument("--hybrid_rosenbrock_n2", type=int, default=5,
                        help="Number of blocks/rows for HybridRosenbrock")
    parser.add_argument("--neal_funnel_mu_v", type=float, default=0.0)
    parser.add_argument("--neal_funnel_sigma_v_sq", type=float, default=9.0)
    parser.add_argument("--neal_funnel_mu_z", type=float, default=0.0)
    parser.add_argument("--super_funnel_J", type=int, default=5)
    parser.add_argument("--super_funnel_K", type=int, default=3)
    parser.add_argument("--super_funnel_n_per_group", type=int, default=20)
    parser.add_argument("--super_funnel_prior_hypermean_std", type=float,
                        default=10.0)
    parser.add_argument("--super_funnel_prior_tau_scale", type=float,
                        default=2.5)


def add_run_args(parser: argparse.ArgumentParser, default_iters: int):
    parser.add_argument("--num_iters", type=int, default=default_iters)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--burn_in", type=int, default=1000)
    parser.add_argument("--num_chains", type=int, default=64,
                        help="Vectorized independent chains/replicas per "
                             "config (the reference runs 1)")
    parser.add_argument("--output_dir", type=str, default="data")
    parser.add_argument("--images_dir", type=str, default="images")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU (plain PyTorch versions of the "
                             "kernels) instead of the card")
    parser.add_argument("--use_mesh", action="store_true",
                        help="Shard chains over several cards (not ported "
                             "yet: raises)")
    parser.add_argument("--rng", type=str, default="threefry2x32",
                        choices=["threefry2x32", "rbg"],
                        help="Accepted for the JAX CLI's sake; the port "
                             "draws Philox4x32-10 either way")
    parser.add_argument("--multihost", action="store_true",
                        help="Multi-host runs (not ported yet: raises)")
    parser.add_argument("--x64", "--use_double_precision", action="store_true",
                        dest="use_double_precision",
                        help="float64 (not ported to the fused kernels: "
                             "raises)")


def resolve_device_from_args(args) -> str:
    """``"cpu"`` with ``--cpu``, else ``"cuda"``; raises for the flags the
    port does not run."""
    for flag, item in (("use_mesh", "A item 13"), ("multihost", "A item 13"),
                       ("use_double_precision", "A item 7")):
        if getattr(args, flag, False):
            raise NotImplementedError(
                f"--{flag} is not ported to the PyTorch package yet "
                f"(ROADMAP Queue {item})")
    return "cpu" if getattr(args, "cpu", False) else "cuda"


def target_kwargs_from_args(args) -> dict:
    """Per-target kwargs of the reference CLIs."""
    kwargs = {}
    if args.target == "HybridRosenbrock":
        kwargs["n1"] = args.hybrid_rosenbrock_n1
        kwargs["n2"] = args.hybrid_rosenbrock_n2
    elif args.target == "NealFunnel":
        kwargs["mu_v"] = args.neal_funnel_mu_v
        kwargs["sigma_v_sq"] = args.neal_funnel_sigma_v_sq
        kwargs["mu_z"] = args.neal_funnel_mu_z
    elif args.target == "SuperFunnel":
        kwargs["J"] = args.super_funnel_J
        kwargs["K"] = args.super_funnel_K
        kwargs["n_per_group"] = args.super_funnel_n_per_group
        kwargs["prior_hypermean_std"] = args.super_funnel_prior_hypermean_std
        kwargs["prior_tau_scale"] = args.super_funnel_prior_tau_scale
    return kwargs


def resolve_actual_dim(args) -> int:
    """``--dim`` for the ported targets; the targets whose dimension derives
    from their own structure are not ported yet."""
    if args.target not in PORTED_TARGETS:
        raise NotImplementedError(
            f"target {args.target!r} is not ported to the PyTorch package "
            f"yet (ROADMAP Queue A item 9); ported: {PORTED_TARGETS}")
    return args.dim


def save_json(data: dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
    print(f"   Results saved to: {path}")


def build_proposal_config(proposal_name: str, scale_param: float, dim: int,
                          anisotropic=None) -> dict:
    """Scale parameter -> proposal_config of the reference sweep:
    Normal/Laplace variance = scale^2/dim, UniformRadius radius = scale."""
    if proposal_name == "Normal":
        return {"name": "Normal",
                "params": {"base_variance_scalar": (scale_param ** 2) / dim}}
    if proposal_name == "Laplace":
        eff = (scale_param ** 2) / dim
        if anisotropic is not None:
            import numpy as np
            vec = (np.asarray(anisotropic, dtype=float) * eff).tolist()
        else:
            vec = eff
        return {"name": "Laplace", "params": {"base_variance_vector": vec}}
    if proposal_name == "UniformRadius":
        return {"name": "UniformRadius", "params": {"base_radius": scale_param}}
    raise ValueError(f"Unknown proposal name: {proposal_name}")
