"""The port imports without JAX and without the JAX package, and its entry
points refuse to run on a missing card unless asked for the CPU."""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "rwm_pt_tpu"):
            sys.modules[name] = None          # any import of them raises
        import rwm_pt_tpu_torch
        import rwm_pt_tpu_torch.convert, rwm_pt_tpu_torch.kernels
        import rwm_pt_tpu_torch.kernels._build
        import rwm_pt_tpu_torch.kernels.agreement
        import rwm_pt_tpu_torch.kernels.draws
        import rwm_pt_tpu_torch.kernels.fused_pt
        import rwm_pt_tpu_torch.kernels.fused_rwm
        import rwm_pt_tpu_torch.analysis.diagnostics
        import rwm_pt_tpu_torch.api.simulation
        import rwm_pt_tpu_torch.cli.common
        import rwm_pt_tpu_torch.cli.experiment_rwm
        import rwm_pt_tpu_torch.ladders.ladders
        import rwm_pt_tpu_torch.proposals.proposals
        import rwm_pt_tpu_torch.targets.registry
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "rwm_pt_tpu")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _entry_points(out_dir):
    from rwm_pt_tpu_torch.api import MCMCSimulation
    from rwm_pt_tpu_torch.cli.experiment_rwm import run_study
    from rwm_pt_tpu_torch.kernels import (run_pt, run_pt_fused, run_rwm,
                                          run_rwm_fused)
    from rwm_pt_tpu_torch.proposals import (LaplaceProposal, NormalProposal,
                                            UniformRadiusProposal,
                                            create_proposal_distribution)
    from rwm_pt_tpu_torch.targets import (MultivariateNormal,
                                          get_target_distribution)
    t = MultivariateNormal.create(2, device="cpu")
    p = NormalProposal.create(2, 1.0, device="cpu")
    kw = dict(num_chains=4, num_iterations=2)
    return {
        "MultivariateNormal.create": lambda **d: MultivariateNormal.create(
            2, **d),
        "NormalProposal.create": lambda **d: NormalProposal.create(2, 1.0,
                                                                   **d),
        "run_rwm": lambda **d: run_rwm(t, p, 0, **kw, **d),
        "run_pt": lambda **d: run_pt(t, p, 0, [1.0, 0.5], **kw, **d),
        "run_rwm_fused": lambda **d: run_rwm_fused(t, 0, base_variance=1.0,
                                                   **kw, **d),
        "run_pt_fused": lambda **d: run_pt_fused(t, 0, [1.0, 0.5],
                                                 base_variance=1.0, **kw,
                                                 **d),
        "LaplaceProposal.create": lambda **d: LaplaceProposal.create(
            2, 1.0, **d),
        "UniformRadiusProposal.create":
            lambda **d: UniformRadiusProposal.create(2, 1.0, **d),
        "create_proposal_distribution":
            lambda **d: create_proposal_distribution(
                2, {"name": "Laplace",
                    "params": {"base_variance_vector": 1.0}}, **d),
        "get_target_distribution": lambda **d: get_target_distribution(
            "FullRosenbrock", 2, **d),
        "MCMCSimulation": lambda **d: MCMCSimulation(
            dim=2, sigma=1.0, num_iterations=2, num_chains=4,
            target_dist="MultivariateNormal", **d).generate_samples(
                verbose=False),
        "run_study": lambda **d: run_study(
            2, num_iters=2, burn_in=0, num_chains=4, num_configs=1,
            output_dir=out_dir, make_plots=False, **d),
    }


@pytest.mark.parametrize("name", ["MultivariateNormal.create",
                                  "NormalProposal.create", "run_rwm",
                                  "run_pt", "run_rwm_fused", "run_pt_fused",
                                  "LaplaceProposal.create",
                                  "UniformRadiusProposal.create",
                                  "create_proposal_distribution",
                                  "get_target_distribution",
                                  "MCMCSimulation", "run_study"])
def test_entry_points_default_to_cuda(name, monkeypatch, tmp_path):
    """With no card, the default device raises; ``device='cpu'`` runs."""
    fn = _entry_points(str(tmp_path))[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fn()
    fn(device="cpu")
