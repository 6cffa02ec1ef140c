"""The port's proposals (rwm_pt_tpu_torch/proposals) against the JAX
package's: log increment densities on the same numpy increments, the
factory's errors, the sampling laws' moments, and conversion of the JAX
fields."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rwm_pt_tpu import proposals as jprop
from rwm_pt_tpu_torch import proposal_from_numpy
from rwm_pt_tpu_torch import proposals as tprop

torch.set_num_threads(1)
CPU = "cpu"

CONFIGS = {
    "Normal": {"base_variance_scalar": 0.7},
    "Laplace-iso": {"base_variance_vector": 0.7},
    "Laplace-aniso": {"base_variance_vector": [0.2, 0.5, 1.0, 1.5, 3.0]},
    "UniformRadius": {"base_radius": 1.3},
}


def _pair(case, d=5):
    cfg = {"name": case.split("-")[0], "params": CONFIGS[case]}
    return (jprop.create_proposal_distribution(d, cfg),
            tprop.create_proposal_distribution(d, cfg, device=CPU))


@pytest.mark.parametrize("case", list(CONFIGS))
@pytest.mark.parametrize("betas", [0.4, (1.0, 0.5, 0.1)],
                         ids=["scalar-beta", "per-rung"])
def test_log_inc_density_matches_jax(case, betas):
    """rtol 1e-6 on the same float32 increments, with a per-rung beta
    vector over the rung axis or one beta; UniformRadius increments on
    both sides of the ball's edge (-inf outside on both)."""
    d = 5
    j, t = _pair(case, d)
    rng = np.random.default_rng(len(case))
    shape = (d, 3, 40) if isinstance(betas, tuple) else (d, 40)
    inc = (rng.normal(size=shape) * 0.9).astype(np.float32)
    b = np.asarray(betas, np.float32)
    ref = np.asarray(j.log_inc_density(jnp.asarray(inc), jnp.asarray(b)))
    ours = t.log_inc_density(torch.from_numpy(inc), torch.from_numpy(b))
    assert tuple(ours.shape) == ref.shape == shape[1:]
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)
    if case == "UniformRadius":
        assert np.isinf(ref).any() and np.isfinite(ref).any()
    # symmetric: the Hastings correction is zero where the density is finite
    q = t.log_q_ratio(torch.from_numpy(inc), torch.from_numpy(b)).numpy()
    assert (q[np.isfinite(ref)] == 0).all()


BAD = [
    (3, {"name": "Normal", "params": {}}),
    (3, {"name": "Laplace", "params": {}}),
    (3, {"name": "UniformRadius", "params": {}}),
    (3, {"name": "Cauchy", "params": {"scale": 1.0}}),
    (3, {"params": {"base_variance_scalar": 1.0}}),
    (3, {"name": "Normal", "params": {"base_variance_scalar": 0.0}}),
    (3, {"name": "Laplace", "params": {"base_variance_vector": [1.0, 2.0]}}),
    (3, {"name": "Laplace",
         "params": {"base_variance_vector": [1.0, -1.0, 2.0]}}),
    (3, {"name": "UniformRadius", "params": {"base_radius": -0.5}}),
]


@pytest.mark.parametrize("dim,cfg", BAD, ids=[
    "normal-missing", "laplace-missing", "radius-missing", "unknown",
    "no-name", "normal-zero", "laplace-shape", "laplace-negative",
    "radius-negative"])
def test_factory_errors_match_jax(dim, cfg):
    with pytest.raises(ValueError) as je:
        jprop.create_proposal_distribution(dim, cfg)
    with pytest.raises(ValueError) as te:
        tprop.create_proposal_distribution(dim, cfg, device=CPU)
    assert str(te.value) == str(je.value)


def test_laplace_sample_moments():
    """Per coordinate and rung: mean 0 and variance v_i / beta_t (a
    Laplace of scale sqrt(v / beta / 2)), within 5 standard errors of
    40,000 draws (the variance's error from the Laplace kurtosis, 6)."""
    v = np.asarray([0.2, 1.0, 3.0], np.float32)
    betas = torch.tensor([1.0, 0.25])
    p = tprop.LaplaceProposal.create(3, v, device=CPU)
    n = 40000
    x = p.sample_td(torch.Generator().manual_seed(1), betas, (2, n)) \
        .double().numpy()
    assert x.shape == (3, 2, n)
    want = v[:, None] / betas.numpy()[None, :]
    assert (np.abs(x.mean(-1)) < 5 * np.sqrt(want / n)).all()
    np.testing.assert_array_less(np.abs(x.var(-1) / want - 1),
                                 5 * np.sqrt(5.0 / n))


def test_uniform_radius_sample_moments():
    """Every increment lies in the ball of radius R / sqrt(beta); the mean
    squared length is R^2 d / (d + 2) and the mean increment 0, within 5
    standard errors, for each rung; and the JAX sampler's mean squared
    length agrees within 5 standard errors."""
    d, R, n = 4, 1.5, 40000
    betas = np.asarray([1.0, 0.3], np.float32)
    p = tprop.UniformRadiusProposal.create(d, R, device=CPU)
    x = p.sample_td(torch.Generator().manual_seed(2), torch.from_numpy(betas),
                    (2, n)).double().numpy()
    r2 = (x ** 2).sum(0)                               # (T, n)
    r_eff = R / np.sqrt(betas)
    assert (np.sqrt(r2) <= r_eff[:, None] * (1 + 1e-6)).all()
    want = r_eff ** 2 * d / (d + 2)
    # Var(r^2) for r = R U^(1/d): R^4 (d/(d+4) - d^2/(d+2)^2)
    sd = r_eff ** 2 * np.sqrt(d / (d + 4) - d ** 2 / (d + 2) ** 2)
    assert (np.abs(r2.mean(-1) - want) < 5 * sd / np.sqrt(n)).all()
    assert (np.abs(x.mean(-1)) < 5 * r_eff / np.sqrt(n)).all()
    import jax
    jp = jprop.UniformRadiusProposal.create(d, R)
    jx = np.asarray(jp.sample_td(jax.random.key(3), jnp.asarray(betas),
                                 (2, n)), np.float64)
    jr2 = (jx ** 2).sum(0)
    se = np.sqrt(r2.var(-1) / n + jr2.var(-1) / n)
    assert (np.abs(r2.mean(-1) - jr2.mean(-1)) < 5 * se).all()


@pytest.mark.parametrize("case", ["Laplace-aniso", "UniformRadius"])
def test_proposal_from_jax_fields(case):
    """A JAX proposal's fields make the same port proposal as its config."""
    j, t = _pair(case)
    field = ("base_variance_vector" if case.startswith("Laplace")
             else "base_radius")
    conv = proposal_from_numpy(t.name, {field: np.asarray(getattr(j, field))},
                               dim=5, device=CPU)
    assert type(conv) is type(t)
    assert torch.equal(getattr(conv, field), getattr(t, field))
