"""The port's RWM proposal study CLI (python -m
rwm_pt_tpu_torch.cli.experiment_rwm) against the JAX package's: the same
JSON keys for each proposal, one run of the fused sampler per config with
its own Philox seed, the shared CLI plumbing, and the optimum's plots from
a recorded fused run."""
import json
import os

import numpy as np
import pytest
import torch

from rwm_pt_tpu.cli import experiment_rwm as jcli
from rwm_pt_tpu.cli.common import build_proposal_config as jbuild
from rwm_pt_tpu_torch.cli import experiment_rwm as tcli
from rwm_pt_tpu_torch.cli.common import build_proposal_config as tbuild
from rwm_pt_tpu_torch.kernels import fused_rwm

torch.set_num_threads(1)
ARGS = ["--dim", "3", "--num_iters", "60", "--burn_in", "10",
        "--num_configs", "3", "--num_chains", "8", "--var_max", "2.5",
        "--seed", "4", "--no_plots"]


@pytest.mark.parametrize("prop", ["Normal", "Laplace", "UniformRadius"])
def test_study_writes_the_jax_json_keys(tmp_path, prop, monkeypatch):
    """Same keys, scale grid and per-config list lengths as the JAX study's
    JSON; ``backend`` is the torch device; one fused run per config, each
    with the seed ``config_seed(seed, i)``."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcli.main(ARGS + ["--proposal", prop, "--cpu", "--output_dir",
                      str(jdir)])
    (jfile,) = os.listdir(jdir)
    with open(jdir / jfile) as f:
        jdata = json.load(f)
    seeds = []
    real = fused_rwm.run_rwm_fused

    def spy(target, seed, **kw):
        seeds.append(seed)
        return real(target, seed, **kw)
    monkeypatch.setattr(tcli, "run_rwm_fused", spy)
    tdata = tcli.main(ARGS + ["--proposal", prop, "--cpu",
                              "--output_dir", str(tdir)])
    assert set(tdata) == set(jdata)
    assert tdata["backend"] == "cpu"
    assert tdata["scale_param_range"] == jdata["scale_param_range"]
    for k in ("expected_squared_jump_distances", "acceptance_rates",
              "times"):
        assert len(tdata[k]) == len(jdata[k]) == 3, k
    for k in ("target_distribution", "proposal_distribution", "dimension",
              "num_iterations", "seed", "num_chains"):
        assert tdata[k] == jdata[k], k
    assert seeds == [tcli.config_seed(4, i) for i in range(3)]
    assert len(set(seeds)) == 3
    (tfile,) = os.listdir(tdir)
    assert tfile == f"MultivariateNormal_{prop}_RWM_GPU_dim3_60iters_seed4.json"
    with open(tdir / tfile) as f:
        assert set(json.load(f)) == set(jdata)
    accs = np.asarray(tdata["acceptance_rates"])
    assert ((accs > 0) & (accs <= 1)).all() and accs[0] > accs[-1]


@pytest.mark.parametrize("prop,scale,aniso", [
    ("Normal", 1.7, None), ("Laplace", 1.7, None),
    ("Laplace", 2.0, [1.0, 2.0, 0.5]), ("UniformRadius", 0.9, None)])
def test_proposal_config_matches_jax(prop, scale, aniso):
    assert tbuild(prop, scale, 3, aniso) == jbuild(prop, scale, 3, aniso)


@pytest.mark.parametrize("flag", ["--use_mesh", "--multihost", "--x64"])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
        tcli.main(ARGS + [flag, "--cpu"])


def test_unported_target_raises():
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tcli.main(ARGS + ["--target", "RoughCarpet", "--cpu"])


def test_optimal_plots_from_a_recorded_run(tmp_path):
    """The plots of the optimum take their trace from a recorded fused run
    (matplotlib is imported there only)."""
    pytest.importorskip("matplotlib")
    tcli.run_study(2, num_iters=40, var_max=2.0, seed=1, burn_in=5,
                   proposal_name="UniformRadius", num_chains=4,
                   num_configs=2, output_dir=str(tmp_path / "d"),
                   images_dir=str(tmp_path / "img"), make_plots=True,
                   device="cpu")
    assert sorted(os.listdir(tmp_path / "img")) == [
        "density2D_MultivariateNormal_UniformRadius_RWM_GPU_dim2_40iters_"
        "seed1.png",
        "traceplot_MultivariateNormal_UniformRadius_RWM_GPU_dim2_40iters_"
        "seed1.png"]
