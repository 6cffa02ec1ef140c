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


TIMES = ("total_time", "times", "mh_steps_per_sec")


def _untimed(data):
    return {k: v for k, v in data.items() if k not in TIMES}


@pytest.mark.parametrize("flag", ["--use_mesh", "--multihost", "--x64"])
def test_unported_flags_raise(flag, tmp_path, capsys, monkeypatch):
    """Every flag runs now.  ``--use_mesh`` (A13) shards the chains over a
    mesh (the CPU here), one sharded run a config, and writes the JSON of
    the run without it but for the times; ``--multihost`` prints JAX's
    single-host line on a lone host, writes that JSON too, and under
    ``WORLD_SIZE=2`` raises naming A13's remainder (meshes across
    processes); ``--x64`` is ported (A7): the study runs on the eager
    engine in float64, never launching the float32 fused kernel."""
    if flag != "--x64":
        base = tcli.main(ARGS + ["--cpu", "--output_dir",
                                 str(tmp_path / "base")])
        calls = []
        real = tcli.run_rwm_fused_sharded

        def spy(target, seed, mesh, **kw):
            calls.append(mesh)
            return real(target, seed, mesh, **kw)
        monkeypatch.setattr(tcli, "run_rwm_fused_sharded", spy)
        capsys.readouterr()
        data = tcli.main(ARGS + [flag, "--cpu", "--output_dir",
                                 str(tmp_path / "flag")])
        out = capsys.readouterr().out
        assert _untimed(data) == _untimed(base)
        if flag == "--use_mesh":
            assert len(calls) == 3 and calls[0].shape == {"chains": 1}
            assert "8 chains sharded over 1 devices" in out
            return
        assert not calls
        assert "[parallel] single-host run" in out
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(NotImplementedError,
                           match="Queue A item 13's remainder"):
            tcli.main(ARGS + [flag, "--cpu"])
        return
    from rwm_pt_tpu_torch.utils import default_float, set_x64
    fused_rwm.launch_rwm_kernel.launches.clear()
    try:
        data = tcli.main(ARGS + [flag, "--cpu", "--output_dir",
                                 str(tmp_path)])
        assert default_float() == torch.float64
    finally:
        set_x64(False)
    assert not fused_rwm.launch_rwm_kernel.launches
    accs = np.asarray(data["acceptance_rates"])
    assert ((accs > 0) & (accs <= 1)).all() and accs[0] > accs[-1]


def test_unported_target_raises(tmp_path):
    """Every registry name is ported; a name outside the registry raises
    the JAX registry's ValueError."""
    args = ARGS + ["--target", "Banana", "--cpu", "--output_dir",
                   str(tmp_path)]
    with pytest.raises(ValueError) as je:
        jcli.main(args)
    with pytest.raises(ValueError) as te:
        tcli.main(args)
    assert str(te.value) == str(je.value)


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


PT_ARGS = ["--target", "ThreeMixture", "--dim", "3", "--num_iters", "40",
           "--burn_in", "10", "--num_configs", "3", "--num_chains", "8",
           "--N_samples_swap_est", "2000", "--iterative_tolerance", "0.01",
           "--iterative_max_pn_steps", "30", "--seed", "4"]


def test_pt_study_writes_the_jax_json_keys(tmp_path, monkeypatch):
    """``experiment_pt``: the JAX study's JSON keys, rate grid and list
    lengths; ``backend`` is the torch device; the ``_PT_GPU_`` file name;
    one fused run per config with the Philox seed ``config_seed(seed, i)``,
    the even/odd pair order and the ladder built by the one-program builder
    with seed ``seed + i``."""
    from rwm_pt_tpu.cli import experiment_pt as jpt
    from rwm_pt_tpu_torch.cli import experiment_pt as tpt
    jdata = jpt.run_study(3, "ThreeMixture", num_iters=40, seed=4,
                          burn_in=10, N_samples_swap_est=2000,
                          iterative_tolerance=0.01, iterative_max_pn_steps=30,
                          num_chains=8, num_configs=3,
                          output_dir=str(tmp_path / "jax"), make_plots=False)
    calls, ladder_seeds = [], []
    real_run = tpt.run_pt_fused
    real_ladder = tpt.construct_iterative_ladder_device

    def spy(target, seed, betas, **kw):
        calls.append((seed, kw["swap_sweep"], len(betas)))
        return real_run(target, seed, betas, **kw)

    def ladder_spy(target, **kw):
        ladder_seeds.append(kw["seed"])
        return real_ladder(target, **kw)
    monkeypatch.setattr(tpt, "run_pt_fused", spy)
    monkeypatch.setattr(tpt, "construct_iterative_ladder_device", ladder_spy)
    tdata = tpt.main(PT_ARGS + ["--cpu", "--no_plots", "--output_dir",
                                str(tmp_path / "port")])
    assert set(tdata) == set(jdata)
    assert tdata["backend"] == "cpu"
    assert tdata["swap_acceptance_rates_range"] == \
        jdata["swap_acceptance_rates_range"]
    for k in ("expected_squared_jump_distances", "acceptance_rates", "times",
              "ladder_sizes"):
        assert len(tdata[k]) == len(jdata[k]) == 3, k
    for k in ("target_distribution", "dimension", "num_iterations", "seed",
              "num_chains"):
        assert tdata[k] == jdata[k], k
    assert [c[0] for c in calls] == [tcli.config_seed(4, i) for i in range(3)]
    assert all(c[1] == "even_odd" for c in calls)
    assert [c[2] for c in calls] == tdata["ladder_sizes"]
    assert ladder_seeds == [4, 5, 6]
    assert os.listdir(tmp_path / "port") == [
        "ThreeMixture_PT_GPU_dim3_40iters_seed4.json"]
    assert all(0 <= a <= 1 for a in tdata["acceptance_rates"])


def test_pt_study_flags(tmp_path, monkeypatch):
    """``--geom_ladder`` runs the geometric ladder; ``--use_mesh`` (A13)
    runs the replicas sharded over a mesh (the CPU here) and writes the
    JSON of the run without it but for the times; a ladder longer than the
    kernel's fit (``_build.target_max_rungs``: 320 at d = 3, one block of
    the thread kernel) raises, naming the layout, instead of falling back
    to the eager engine."""
    from rwm_pt_tpu_torch.cli import experiment_pt as tpt
    data = tpt.main(PT_ARGS + ["--geom_ladder", "--cpu", "--no_plots",
                               "--output_dir", str(tmp_path)])
    assert data["ladder_sizes"] == [8, 8, 8]
    meshed = tpt.main(PT_ARGS + ["--geom_ladder", "--use_mesh", "--cpu",
                                 "--no_plots", "--output_dir",
                                 str(tmp_path / "mesh")])
    assert _untimed(meshed) == _untimed(data)
    from rwm_pt_tpu_torch.kernels import _build
    from rwm_pt_tpu_torch.targets import get_target_distribution
    fit = _build.target_max_rungs(get_target_distribution(
        "ThreeMixture", 3, variant="pt_gpu", device="cpu"))
    assert fit == 320
    monkeypatch.setattr(tpt, "construct_geometric_ladder",
                        lambda: list(np.geomspace(1.0, 0.01, fit + 1)))
    with pytest.raises(NotImplementedError,
                       match=f"{fit + 1} rungs.*at most {fit} .one thread"):
        tpt.main(PT_ARGS + ["--geom_ladder", "--cpu", "--no_plots",
                            "--output_dir", str(tmp_path)])


SINGLE_ARGS = ["--dim", "3", "--num_iters", "300", "--burn_in", "300",
               "--num_chains", "16", "--seed", "5", "--no_plots", "--cpu"]


@pytest.mark.parametrize("extra", [
    ["--autotune"], ["--autotune", "--algorithm", "PT"],
    ["--diagnostics", "4", "--algorithm", "PT", "--proposal", "Laplace"]],
    ids=["autotune-rwm", "autotune-pt", "diagnostics-pt"])
def test_single_run_writes_the_jax_json_keys(tmp_path, extra):
    """``single_run`` writes a JSON file of the JAX CLI's name whose keys
    are the JAX CLI's on the same arguments; with ``--autotune`` that
    includes the tuned multiplier and ``tuned_proposal_config``, whose
    keys and lengths match JAX's too."""
    from rwm_pt_tpu.cli import single_run as jsingle
    from rwm_pt_tpu_torch.cli import single_run as tsingle
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsingle.main(SINGLE_ARGS + extra + ["--output_dir", str(jdir)])
    (jfile,) = os.listdir(jdir)
    with open(jdir / jfile) as f:
        jdata = json.load(f)
    tdata = tsingle.main(SINGLE_ARGS + extra + ["--output_dir", str(tdir)])
    (tfile,) = os.listdir(tdir)
    assert tfile == jfile.replace("TPU", "GPU")
    with open(tdir / tfile) as f:
        assert json.load(f) == json.loads(json.dumps(tdata))
    assert set(tdata) == set(jdata)
    if "--autotune" in extra:
        tc, jc = tdata["tuned_proposal_config"], jdata["tuned_proposal_config"]
        assert tc["name"] == jc["name"] and set(tc["params"]) == set(
            jc["params"])
        assert np.shape(tdata["tuned_scale_multiplier"]) == np.shape(
            jdata["tuned_scale_multiplier"])
    for k in ("dimension", "num_iterations", "seed", "num_chains",
              "scale_param"):
        assert tdata[k] == jdata[k], k
    assert 0 < tdata["acceptance_rate"] <= 1


def test_single_run_plots(tmp_path):
    """The plot suite draws from the recorded chain (matplotlib imported
    there only): trace plot, histogram and the marginals."""
    pytest.importorskip("matplotlib")
    from rwm_pt_tpu_torch.cli import single_run as tsingle
    tsingle.run_single_simulation(
        2, "MultivariateNormal", 200, 2.38, 1, 50, num_chains=4,
        output_dir=str(tmp_path / "d"), images_dir=str(tmp_path / "img"),
        device="cpu")
    names = sorted(os.listdir(tmp_path / "img"))
    assert len(names) == 3 and names[1].startswith("marginals_")
    with pytest.raises(ValueError, match="--diagnostics"):
        tsingle.run_single_simulation(2, "MultivariateNormal", 20, 1.0, 1,
                                      200, autotune=True, diagnostics=4,
                                      device="cpu")
