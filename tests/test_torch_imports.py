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


def _entry_points():
    from rwm_pt_tpu_torch.kernels import (run_pt, run_pt_fused, run_rwm,
                                          run_rwm_fused)
    from rwm_pt_tpu_torch.proposals import NormalProposal
    from rwm_pt_tpu_torch.targets import MultivariateNormal
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
    }


@pytest.mark.parametrize("name", ["MultivariateNormal.create",
                                  "NormalProposal.create", "run_rwm",
                                  "run_pt", "run_rwm_fused", "run_pt_fused"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """With no card, the default device raises; ``device='cpu'`` runs."""
    fn = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fn()
    fn(device="cpu")
