"""The port's harness (rwm_pt_tpu_torch.api.MCMCSimulation) and its parts
(target registry, geometric ladder) against the JAX package's: rates and
output shapes on the same configuration for each proposal, checkpoints
that resume across the two packages, the constructor's checks and the
options that are not ported yet."""
import json

import numpy as np
import pytest
import torch

from _torch_port_helpers import rate_z
from rwm_pt_tpu.api import MCMCSimulation as JSim
from rwm_pt_tpu.ladders import construct_geometric_ladder as jladder
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.api import MCMCSimulation as TSim
from rwm_pt_tpu_torch.ladders import construct_geometric_ladder as tladder
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"
PARAMS = {"Normal": {"base_variance_scalar": 1.2},
          "Laplace": {"base_variance_vector": [0.6, 0.9, 1.2, 1.5, 1.8]},
          "UniformRadius": {"base_radius": 2.2}}


@pytest.mark.parametrize("prop", list(PARAMS))
@pytest.mark.parametrize("algo", ["RWM", "PT"])
def test_harness_matches_jax(algo, prop):
    """MVN d=5, 128 chains (PT: 3 rungs, sequential sweep on both sides),
    recorded: per-chain acceptance (PT: swap acceptance) and ESJD (PT: the
    cold chain's) within 5 Monte-Carlo standard errors of the JAX harness,
    and every output of the same shape.  The port's 'auto' engine takes
    the fused samplers (their plain versions on the CPU)."""
    kw = dict(dim=5, proposal_config={"name": prop, "params": PARAMS[prop]},
              num_iterations=200, algorithm=algo,
              target_dist="MultivariateNormal", seed=3, burn_in=50,
              num_chains=128, swap_every=10, swap_sweep="sequential",
              beta_ladder=[1.0, 0.5, 0.25] if algo == "PT" else None,
              record_chains=4)
    js, ts = JSim(**kw), TSim(**kw, device=CPU)
    jc, tc = js.generate_samples(verbose=False), ts.generate_samples(
        verbose=False)
    assert ts.engine_used == "pallas"
    assert tc.shape == jc.shape == (200, 5) and np.isfinite(tc).all()
    for fn in ("effective_sample_size", "split_rhat", "mcse_mean",
               "integrated_autocorr_time"):
        a, b = getattr(ts, fn)(), getattr(js, fn)()
        assert a.shape == b.shape == (5,) and np.isfinite(a).all(), fn
    assert ts._get_chains_3d().shape == js._get_chains_3d().shape
    assert rate_z(ts.acceptance_rate_per_chain(),
                  js.acceptance_rate_per_chain()) < 5
    assert rate_z(ts.expected_squared_jump_distance_per_chain(),
                  js.expected_squared_jump_distance_per_chain()) < 5
    ti, ji = ts.get_diagnostic_info(), js.get_diagnostic_info()
    assert set(ti) == set(ji)
    assert ti["backend"] == "cpu" and ti["engine"] == "pallas"
    if algo == "PT":
        assert ti["num_temps"] == ji["num_temps"] == 3
        assert abs(ti["pt_esjd"] - ji["pt_esjd"]) < 0.05


@pytest.mark.parametrize("algo", ["RWM", "PT"])
def test_checkpoint_round_trip_with_jax(tmp_path, algo):
    """A checkpoint written by the JAX harness resumes in the port, and the
    port's resumes in the JAX harness, with cumulative step counts; both
    files hold the same arrays (``arr_0..``) and ``meta`` keys."""
    kw = dict(dim=3, sigma=1.0, num_iterations=40, algorithm=algo,
              target_dist="MultivariateNormal", seed=1, burn_in=10,
              num_chains=16, swap_every=5, record_chain=False,
              beta_ladder=[1.0, 0.5] if algo == "PT" else None)
    js = JSim(**kw)
    js.generate_samples(verbose=False)
    js.save_checkpoint(str(tmp_path / "jax"))
    ts = TSim(**kw, device=CPU)
    r = ts.resume(str(tmp_path / "jax"), num_iterations=20)
    assert r.state.step == 70
    jstate = js._result.state
    assert (r.state.accept_count.numpy()
            >= np.asarray(jstate.accept_count)).all()
    ts.save_checkpoint(str(tmp_path / "port"))
    js2 = JSim(**kw)
    r2 = js2.resume(str(tmp_path / "port"), num_iterations=10)
    assert int(r2.state.step) == 80
    assert (np.asarray(r2.state.accept_count)
            >= r.state.accept_count.numpy()).all()
    fj, fp = (np.load(tmp_path / f"{n}.npz") for n in ("jax", "port"))
    assert sorted(fj.files) == sorted(fp.files)
    for k in fj.files:
        if k == "meta":
            assert (set(json.loads(str(fj[k])))
                    == set(json.loads(str(fp[k]))))
        else:
            assert fj[k].shape == fp[k].shape, k
            assert fj[k].dtype == fp[k].dtype, k


@pytest.mark.parametrize("engine", ["pallas", "scan"])
def test_checkpoint_every_equals_uninterrupted(tmp_path, engine):
    """Segments of 15 steps with a checkpoint after each draw what one run
    draws (randomness keyed on the absolute step); the last checkpoint
    holds the final state."""
    kw = dict(dim=4, sigma=0.8, num_iterations=45, algorithm="PT",
              target_dist="FullRosenbrock", seed=5, burn_in=5,
              num_chains=8, swap_every=4, beta_ladder=[1.0, 0.5, 0.2],
              record_chain=False, engine=engine, device=CPU)
    whole = TSim(**kw)
    whole.generate_samples(verbose=False)
    seg = TSim(**kw)
    path = str(tmp_path / "ck")
    seg.generate_samples(verbose=False, checkpoint_every=15,
                         checkpoint_path=path)
    a, b = whole._result.state, seg._result.state
    for f in ("x", "accept_count", "swap_accept_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert seg.engine_used == engine
    state, meta = seg.restore_state(path)
    assert state.step == 50 and meta["engine"] == engine
    assert torch.equal(state.x, b.x)


@pytest.mark.parametrize("bad", [
    dict(sigma=None),
    dict(record_chains=9),
    dict(swap_sweep="random"),
    dict(engine="xla"),
    dict(algorithm="PT", geom_temp_spacing=True,
         iterative_temp_spacing=True),
    dict(proposal_config={"name": "Normal", "params": {
        "base_variance_scalar": 1.0, "rung_scale_multipliers": [1.0]}}),
], ids=["no-proposal", "record-chains", "sweep", "engine", "ladders",
        "rung-multipliers-rwm"])
def test_constructor_errors_match_jax(bad):
    kw = dict(dim=3, sigma=1.0, num_iterations=10, algorithm="RWM",
              target_dist="MultivariateNormal", num_chains=8)
    kw.update(bad)
    with pytest.raises(ValueError) as je:
        JSim(**kw)
    with pytest.raises(ValueError) as te:
        TSim(**kw, device=CPU)
    assert str(te.value) == str(je.value)


def test_rng_impl_takes_the_jax_values():
    """Every JAX ``rng_impl`` is accepted and draws the same Philox stream;
    any other value raises."""
    kw = dict(dim=3, sigma=1.0, num_iterations=20, num_chains=8,
              target_dist="MultivariateNormal", record_chain=False,
              device=CPU)
    runs = []
    for impl in ("threefry2x32", "rbg", "unsafe_rbg"):
        sim = TSim(rng_impl=impl, **kw)
        sim.generate_samples(verbose=False)
        runs.append(sim._result.state.x)
    assert all(torch.equal(runs[0], x) for x in runs[1:])
    with pytest.raises(ValueError, match="rng_impl"):
        TSim(rng_impl="mt19937", **kw)


@pytest.mark.parametrize("opt,item", [
    (dict(algorithm="PT", iterative_temp_spacing=True), "A item 10"),
    (dict(autotune=True), "A item 11"),
    (dict(algorithm="PT", autotune_ladder=True), "A item 11"),
    (dict(use_mesh=True), "A item 13"),
    (dict(cpu_semantics=True), "A item 7"),
    (dict(symmetric=False), "A item 7"),
])
def test_options_not_ported_raise(opt, item):
    kw = dict(dim=3, sigma=1.0, num_iterations=10, algorithm="RWM",
              target_dist="MultivariateNormal", num_chains=8, device=CPU)
    kw.update(opt)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue {item}"):
        TSim(**kw)


def test_progress_bar_and_engine_refusal():
    sim = TSim(dim=3, sigma=1.0, num_iterations=10,
               target_dist="MultivariateNormal", device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 7"):
        sim.generate_samples(progress_bar=True)
    full = TSim(dim=3, sigma=1.0, num_iterations=10, engine="pallas",
                target_dist=tget("MultivariateNormal", 3,
                                 cov=np.diag([1.0, 2.0, 3.0]), device=CPU),
                device=CPU)
    with pytest.raises(ValueError, match="fused CUDA kernels"):
        full.generate_samples(verbose=False)
    auto = TSim(dim=3, sigma=1.0, num_iterations=10, record_chains=1,
                target_dist=full.target_dist, device=CPU)
    assert auto.generate_samples(verbose=False).shape == (10, 3)
    assert auto.engine_used == "scan"


def test_registry_matches_jax():
    """The factory defaults of the ported targets, the ``variant`` check
    and the unknown-name error are the JAX registry's; every other JAX
    target name raises ``NotImplementedError`` naming ROADMAP Queue A
    item 9."""
    jr, tr = jget("FullRosenbrock", 6), tget("FullRosenbrock", 6, device=CPU)
    for f in ("a_coeff", "b_coeff", "mu"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    jm, tm = jget("MultivariateNormal", 4), tget("MultivariateNormal", 4,
                                                  device=CPU)
    assert bool(tm.iso) == bool(jm.iso)
    np.testing.assert_allclose(float(tm.log_norm_const),
                               float(jm.log_norm_const), rtol=1e-6)
    for args, kw in ((("Banana", 3), {}),
                     (("MultivariateNormal", 3), {"variant": "gpu"})):
        with pytest.raises(ValueError) as je:
            jget(*args, **kw)
        with pytest.raises(ValueError) as te:
            tget(*args, **kw, device=CPU)
        assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        tget("ThreeMixture", 3, device=CPU)


@pytest.mark.parametrize("args", [(), (1.0, 0.05, 0.6), (0.8, 0.001, 0.3)])
def test_geometric_ladder_matches_jax(args):
    assert tladder(*args) == jladder(*args)
