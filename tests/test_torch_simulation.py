"""The port's harness (rwm_pt_tpu_torch.api.MCMCSimulation) and its parts
(target registry, geometric ladder) against the JAX package's: rates and
output shapes on the same configuration for each proposal, checkpoints
that resume across the two packages, the constructor's checks, burn-in
autotuning (the two-phase handoff to the fused samplers, the diagnostics
and the tuned proposal config) and the options that are not ported
yet."""
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
    (dict(use_mesh=True), "A item 13"),
    (dict(cpu_semantics=True), "A item 7"),
    (dict(symmetric=False), "A item 7"),
])
def test_options_not_ported_raise(opt, item):
    """Every option runs now.  ``use_mesh`` (A13) builds a mesh over the
    harness's device (the CPU here) and gives the fused run without the
    mesh bit for bit, RWM and PT; a recorded run with a mesh takes the
    eager engine, as JAX's does.  The A7 options are ported and run on the
    eager engine (the fused kernels refuse them, as JAX's Pallas kernels
    do)."""
    kw = dict(dim=3, sigma=1.0, num_iterations=10, algorithm="RWM",
              target_dist="MultivariateNormal", num_chains=8, device=CPU)
    kw.update(opt)
    if item != "A item 7":
        for algo in ("RWM", "PT"):
            kw.update(algorithm=algo, record_chain=False,
                      beta_ladder=[1.0, 0.5, 0.2], swap_every=2)
            sims = [TSim(**dict(kw, use_mesh=m)) for m in (False, True)]
            for sim in sims:
                sim.generate_samples(verbose=False)
                assert sim.engine_used == "pallas"
            assert sims[0].mesh is None
            assert sims[1].mesh.shape == {"chains": 1}
            for f in ("x", "logp", "accept_count"):
                assert torch.equal(getattr(sims[0]._result.state, f),
                                   getattr(sims[1]._result.state, f)), f
        rec = TSim(**dict(kw, record_chain=True))
        rec.generate_samples(verbose=False)
        assert rec.engine_used == "scan"
        with pytest.raises(ValueError, match="no mesh when recording"):
            TSim(**dict(kw, record_chain=True), engine="pallas") \
                .generate_samples(verbose=False)
        return
    sim = TSim(**kw)
    sim.generate_samples(verbose=False)
    assert sim.engine_used == "scan"
    with pytest.raises(ValueError, match="fused CUDA kernels"):
        TSim(**kw, engine="pallas").generate_samples(verbose=False)


def test_progress_bar_and_engine_refusal(capsys):
    """``progress_bar=True`` (A7) prints JAX's lines: a fused run in ten
    segments, a line after each."""
    sim = TSim(dim=3, sigma=1.0, num_iterations=10, record_chain=False,
               target_dist="MultivariateNormal", device=CPU)
    sim.generate_samples(progress_bar=True)
    assert sim.engine_used == "pallas"
    assert "progress: 10/10 iterations" in capsys.readouterr().out
    # the kernels compile dims up to 4092 (teams of lanes above 64): a
    # 4093-d target is refused by engine='pallas' and runs on the eager
    # engine under 'auto'; a 65-d one takes the fused kernels
    wide = TSim(dim=4093, sigma=0.01, num_iterations=10, engine="pallas",
                target_dist=tget("FullRosenbrock", 4093, device=CPU),
                device=CPU)
    with pytest.raises(ValueError, match="fused CUDA kernels"):
        wide.generate_samples(verbose=False)
    auto = TSim(dim=1021, sigma=0.01, num_iterations=10, record_chains=1,
                target_dist=wide.target_dist, device=CPU)
    assert auto.generate_samples(verbose=False).shape == (10, 4093)
    assert auto.engine_used == "scan"
    auto65 = TSim(dim=65, sigma=0.01, num_iterations=10, record_chains=1,
                  target_dist=tget("FullRosenbrock", 65, device=CPU),
                  device=CPU)
    assert auto65.generate_samples(verbose=False).shape == (10, 65)
    assert auto65.engine_used == "pallas"
    # the full-covariance MVN is a kernel target of its own
    full = TSim(dim=3, sigma=1.0, num_iterations=10, engine="pallas",
                target_dist=tget("MultivariateNormal", 3,
                                 cov=np.diag([1.0, 2.0, 3.0]), device=CPU),
                device=CPU)
    assert full.generate_samples(verbose=False).shape == (10, 3)
    assert full.engine_used == "pallas"


def test_registry_matches_jax():
    """The factory defaults of the ported targets (SuperFunnel's dataset
    too), the ``variant`` check and the unknown-name error are the JAX
    registry's."""
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
    js, ts = jget("SuperFunnel", 3), tget("SuperFunnel", 3, device=CPU)
    assert (ts.dim, ts.J, ts.K) == (js.dim, js.J, js.K) == (26, 5, 3)
    for f in ("X_cols", "Y", "prior_hypermean_std", "prior_tau_scale"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))


@pytest.mark.parametrize("args", [(), (1.0, 0.05, 0.6), (0.8, 0.001, 0.3)])
def test_geometric_ladder_matches_jax(args):
    assert tladder(*args) == jladder(*args)


AUTOTUNE_BAD = {
    "record-chain": dict(autotune=True, burn_in=200, record_chain=True),
    "burn-in": dict(autotune=True),
    "cpu-semantics": dict(algorithm="PT", autotune=True, burn_in=200,
                          cpu_semantics=True),
    "pallas-mesh": dict(autotune=True, burn_in=200, engine="pallas",
                        use_mesh=True),
    "record-chains": dict(autotune=True, burn_in=200, record_chains=4),
    "ladder-rwm": dict(autotune_ladder=True, burn_in=200),
    "ladder-exclusive": dict(algorithm="PT", autotune=True,
                             autotune_ladder=True, burn_in=200),
    "ladder-iterative": dict(algorithm="PT", autotune_ladder=True,
                             iterative_temp_spacing=True, burn_in=200),
    "ladder-cpu-semantics": dict(algorithm="PT", autotune_ladder=True,
                                 burn_in=200, cpu_semantics=True),
    "ladder-pallas-mesh": dict(algorithm="PT", autotune_ladder=True,
                               burn_in=200, engine="pallas", use_mesh=True),
    "ladder-record-chain": dict(algorithm="PT", autotune_ladder=True,
                                burn_in=200, record_chain=True),
    "ladder-burn-in": dict(algorithm="PT", autotune_ladder=True, burn_in=50),
}


@pytest.mark.parametrize("case", list(AUTOTUNE_BAD))
def test_autotune_validation_matches_jax(case):
    """tests/test_adaptive.py's test_api_autotune_validation and
    test_api_autotune_ladder_validation: the constructor refuses JAX's
    invalid autotune and autotune_ladder combinations with JAX's
    ValueErrors, in JAX's order."""
    kw = dict(dim=2, sigma=1.0, num_iterations=10, algorithm="RWM",
              target_dist="MultivariateNormal", num_chains=8)
    kw.update(AUTOTUNE_BAD[case])
    with pytest.raises(ValueError) as je:
        JSim(**kw)
    with pytest.raises(ValueError) as te:
        TSim(**kw, device=CPU)
    assert str(te.value) == str(je.value)


def test_autotune_run_refusals(monkeypatch):
    """engine='pallas' refuses a run the fused samplers cannot take before
    spending the tuning burn-in; autotune and checkpoint_every cannot be
    combined (JAX's message)."""
    from rwm_pt_tpu_torch.api import simulation
    monkeypatch.setattr(simulation, "run_rwm_adaptive", None)   # never run
    wide = TSim(dim=4093, sigma=0.01, num_iterations=10, autotune=True,
                burn_in=200, engine="pallas",
                target_dist=tget("FullRosenbrock", 4093, device=CPU),
                device=CPU)
    with pytest.raises(ValueError, match="autotune with engine='pallas'"):
        wide.generate_samples(verbose=False)
    kw = dict(dim=2, sigma=1.0, num_iterations=50, algorithm="RWM",
              target_dist="MultivariateNormal", num_chains=2, burn_in=200,
              autotune=True)
    with pytest.raises(ValueError) as je:
        JSim(**kw).generate_samples(verbose=False, checkpoint_every=10,
                                    checkpoint_path="ck")
    with pytest.raises(ValueError) as te:
        TSim(**kw, device=CPU).generate_samples(
            verbose=False, checkpoint_every=10, checkpoint_path="ck")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("mode", ["RWM", "PT", "ladder"])
def test_two_phase_autotune_one_fused_run(mode, monkeypatch):
    """engine='pallas': the adaptive engine runs exactly the burn-in
    (num_iterations=0), then one fused run (the plain version on the CPU)
    measures num_iterations steps from the tuned state, with the full
    per-rung multipliers (PT), the multiplier folded into the proposal
    (RWM) or the tuned ladder; engine_used is 'pallas'."""
    from rwm_pt_tpu_torch.api import simulation
    calls, tunes = [], []
    for name in ("run_pt_fused", "run_rwm_fused", "run_rwm_adaptive",
                 "run_pt_adaptive", "run_pt_ladder_adaptive"):
        real = getattr(simulation, name)

        def spy(*a, _real=real, _name=name, **k):
            (tunes if "adaptive" in _name else calls).append((_name, a, k))
            return _real(*a, **k)
        monkeypatch.setattr(simulation, name, spy)
    sim = TSim(dim=4, sigma=2.38 ** 2 / 4 / 30, num_iterations=300,
               algorithm="RWM" if mode == "RWM" else "PT",
               target_dist="MultivariateNormal", num_chains=64, burn_in=1000,
               swap_every=10, beta_ladder=[1.0, 0.5, 0.25],
               autotune=mode != "ladder", autotune_ladder=mode == "ladder",
               engine="pallas", device=CPU)
    assert sim.generate_samples(verbose=False) is None
    assert sim.engine_used == "pallas"
    assert len(tunes) == 1 and tunes[0][2]["num_iterations"] == 0
    assert len(calls) == 1
    name, a, k = calls[0]
    assert name == ("run_rwm_fused" if mode == "RWM" else "run_pt_fused")
    assert k["num_iterations"] == 300 and k["resume_state"].step == 1000
    res = sim._result
    assert res.state.step == 1300
    if mode == "PT":
        np.testing.assert_array_equal(
            k["scale_multipliers"].numpy(),
            sim.get_diagnostic_info()["tuned_scale_multiplier"])
        assert (res.acceptance_rate.mean(1) - 0.234).abs().max() < 0.1
    elif mode == "RWM":
        c = sim.get_diagnostic_info()["tuned_scale_multiplier"]
        assert abs(float(k["proposal"].base_variance_scalar)
                   - 2.38 ** 2 / 4 / 30 * c) < 1e-6 * c
        assert abs(sim.acceptance_rate() - 0.234) < 0.1
    else:
        assert k["scale_multipliers"] is None
        assert sim.beta_ladder == sim.tuned_ladder != [1.0, 0.5, 0.25]
        assert a[2].tolist() == sim.tuned_ladder
    ps = sim._phase_seconds
    assert ps["tune"] > 0 and ps["measure"] > 0


@pytest.mark.parametrize("mode", ["RWM", "PT", "ladder"])
def test_autotune_diagnostics_keys_match_jax(mode):
    """An autotuned run's get_diagnostic_info has the JAX harness's keys
    (autotune_target and tuned_scale_multiplier, or
    autotune_ladder_target and tuned_beta_ladder)."""
    kw = dict(dim=3, sigma=0.5, num_iterations=100,
              algorithm="RWM" if mode == "RWM" else "PT",
              target_dist="MultivariateNormal", num_chains=16, burn_in=200,
              swap_every=10, beta_ladder=[1.0, 0.5, 0.25],
              autotune=mode != "ladder", autotune_ladder=mode == "ladder")
    js, ts = JSim(**kw), TSim(**kw, device=CPU)
    js.generate_samples(verbose=False)
    ts.generate_samples(verbose=False)
    ti, ji = ts.get_diagnostic_info(), js.get_diagnostic_info()
    assert set(ti) == set(ji)
    assert ts.engine_used == js.engine_used == "scan"
    if mode == "ladder":
        assert ti["tuned_beta_ladder"] == ts.tuned_ladder == ts.beta_ladder
        assert len(ts.tuned_ladder) == len(js.tuned_ladder) == 3
        with pytest.raises(ValueError, match="autotune=True first"):
            ts.tuned_proposal_config()
    else:
        assert np.shape(ti["tuned_scale_multiplier"]) == np.shape(
            ji["tuned_scale_multiplier"])
        assert ti["autotune_target"] == ji["autotune_target"] == 0.234


def test_autotune_rwm_integration():
    """tests/test_adaptive.py:79-90: RWM from 1/50 of the optimal variance
    lands at 0.234 acceptance; the tuned config carries the grown
    variance."""
    opt = 2.38 ** 2 / 10
    sim = TSim(dim=10, sigma=opt / 50.0, num_iterations=2000,
               algorithm="RWM", target_dist="MultivariateNormal",
               num_chains=256, burn_in=3000, autotune=True, device=CPU)
    assert sim.generate_samples(verbose=False) is None
    assert abs(sim.acceptance_rate() - 0.234) < 0.05
    info = sim.get_diagnostic_info()
    assert info["autotune_target"] == 0.234
    assert info["tuned_scale_multiplier"] > 1.0
    cfg = sim.tuned_proposal_config()
    assert cfg["params"]["base_variance_scalar"] > opt / 50.0


def test_tuned_proposal_config_round_trip():
    """tests/test_adaptive.py:233-257: a PT run tuned from a 50x-oversized
    base carries every rung's multiplier in tuned_proposal_config(); a
    fresh, untuned simulation on the fused samplers with that config and
    the same ladder reproduces 0.234 per rung (atol 0.06)."""
    opt = 2.38 ** 2 / 10
    betas = [1.0, 0.4, 0.15, 0.05]
    sim = TSim(dim=10, sigma=50.0, num_iterations=3000, algorithm="PT",
               target_dist="MultivariateNormal", num_chains=128,
               burn_in=3000, autotune=True, beta_ladder=betas, swap_every=10,
               device=CPU)
    sim.generate_samples(verbose=False)
    cfg = sim.tuned_proposal_config()
    mult = cfg["params"]["rung_scale_multipliers"]
    assert len(mult) == 4
    assert all(0.3 < m * 50.0 / opt < 3.0 for m in mult)
    sim2 = TSim(dim=10, proposal_config=cfg, num_iterations=3000,
                algorithm="PT", target_dist="MultivariateNormal",
                num_chains=128, burn_in=500, beta_ladder=betas,
                swap_every=10, record_chain=False, device=CPU)
    sim2.generate_samples(verbose=False)
    assert sim2.engine_used == "pallas"
    acc = sim2._result.acceptance_rate.mean(1).numpy()
    np.testing.assert_allclose(acc, 0.234, atol=0.06)
