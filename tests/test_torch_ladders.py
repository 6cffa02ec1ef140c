"""The port's iterative ladder construction (rwm_pt_tpu_torch.ladders)
against the JAX package's host loop: with one deterministic swap estimator
patched into both packages the two ladders are equal, rescue path
included; with their own Monte-Carlo estimators they agree rung for rung
to 5 %; and ``MCMCSimulation(iterative_temp_spacing=True)`` builds its
ladder with it."""
import numpy as np
import pytest
import torch

from rwm_pt_tpu.api import MCMCSimulation as JSim
from rwm_pt_tpu.ladders import ladders as jladders
from rwm_pt_tpu.targets import MultivariateNormal as JMVN
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.api import MCMCSimulation as TSim
from rwm_pt_tpu_torch.ladders import ladders as tladders
from rwm_pt_tpu_torch.targets import MultivariateNormal
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"


def _fake_estimate(target, key, beta_curr, beta_star, n_samples):
    """A deterministic swap rate of the two (float32) betas: the Gaussian
    law exp(-c d (log(beta / beta*))^2) with a noise term that makes
    every probe differ."""
    bc, bs = float(beta_curr), float(beta_star)
    r = np.log(bc / bs)
    return float(np.exp(-0.35 * target.dim * r * r)
                 + 0.004 * np.sin(1e3 * bs))


@pytest.mark.parametrize("kw", [
    dict(target_swap_acceptance_rate=0.234),
    dict(target_swap_acceptance_rate=0.4, tolerance=0.001),
    dict(target_swap_acceptance_rate=0.1, tolerance=1e-4,
         max_pn_adjustment_steps=6, convergence_failure_tolerance_factor=50),
], ids=["default", "tight", "rescue"])
def test_ladder_equals_jax_with_one_estimator(monkeypatch, kw):
    monkeypatch.setattr(jladders, "_estimate_swap_prob", _fake_estimate)
    monkeypatch.setattr(tladders, "_estimate_swap_prob", _fake_estimate)
    j = jladders.construct_iterative_ladder(JMVN.create(6), seed=3, **kw)
    t = tladders.construct_iterative_ladder(
        MultivariateNormal.create(6, device=CPU), seed=3, **kw)
    assert t == j
    assert len(t) > 2 and t[0] == 1.0 and t[-1] == 0.01


def test_ladder_matches_jax_with_real_estimators():
    """MVN d=10, 100,000 samples a probe: the same number of rungs, each
    beta within 5 %."""
    kw = dict(target_swap_acceptance_rate=0.234, N_samples_swap_est=100000)
    j = jladders.construct_iterative_ladder(JMVN.create(10), seed=1, **kw)
    t = tladders.construct_iterative_ladder(
        MultivariateNormal.create(10, device=CPU), seed=1, **kw)
    assert len(t) == len(j)
    np.testing.assert_allclose(t, j, rtol=0.05)


def test_ladder_needs_a_direct_sampler():
    with pytest.raises(NotImplementedError, match="direct_sample"):
        jladders.construct_iterative_ladder(jget("FullRosenbrock", 3))
    with pytest.raises(NotImplementedError, match="direct_sample"):
        tladders.construct_iterative_ladder(
            tget("FullRosenbrock", 3, device=CPU))


def test_harness_builds_the_iterative_ladder(monkeypatch):
    """``iterative_temp_spacing=True`` builds the ladder from the
    harness's seed with the JAX keyword mapping, on both packages the same
    ladder under one estimator; the algorithm's name carries
    ``ITERATIVE_LADDER``; the run goes to the fused sampler."""
    monkeypatch.setattr(jladders, "_estimate_swap_prob", _fake_estimate)
    monkeypatch.setattr(tladders, "_estimate_swap_prob", _fake_estimate)
    kw = dict(dim=4, sigma=0.6, num_iterations=30, algorithm="PT",
              target_dist="ThreeMixture", seed=5, num_chains=8,
              iterative_temp_spacing=True, swap_acceptance_rate=0.3,
              iterative_tolerance=0.002, iterative_max_pn_steps=40,
              record_chain=False)
    js, ts = JSim(**kw), TSim(**kw, device=CPU)
    assert ts.beta_ladder == js.beta_ladder
    assert js.algorithm_name == "PT_RWM_TPU_ITERATIVE_LADDER"
    assert ts.algorithm_name == "PT_RWM_GPU_ITERATIVE_LADDER"
    ts.generate_samples(verbose=False)
    assert ts.engine_used == "pallas"
    assert ts.get_diagnostic_info()["num_temps"] == len(js.beta_ladder)
