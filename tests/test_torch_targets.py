"""The port's targets and proposal against the JAX package, on the same
numpy inputs.  Targets cross through rwm_pt_tpu_torch.convert from the JAX
dataclass fields."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwm_pt_tpu.proposals import NormalProposal as JNormalProposal
from rwm_pt_tpu.targets import FullRosenbrock as JFullRosenbrock
from rwm_pt_tpu.targets import MultivariateNormal as JMVN
from rwm_pt_tpu_torch.convert import proposal_from_numpy, target_from_numpy
from rwm_pt_tpu_torch.proposals import NormalProposal
from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal
from rwm_pt_tpu_torch.utils import default_float, set_x64

torch.set_num_threads(1)
RTOL, ATOL = 1e-6, 1e-5     # f32 rounding of the sums over d


def _fields(jt, names):
    return {k: np.asarray(getattr(jt, k)) for k in names}


def _jax_targets():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(10, 10)).astype(np.float32)
    cov = (a @ a.T / 10 + np.eye(10)).astype(np.float32)
    mean = rng.normal(size=10).astype(np.float32)
    return {
        "rosenbrock30": (JFullRosenbrock.create(30), "FullRosenbrock",
                         ("a_coeff", "b_coeff", "mu")),
        "mvn_iso": (JMVN.create(10, mean=mean), "MultivariateNormal",
                    ("mean", "cov", "cov_inv", "chol", "log_norm_const",
                     "iso")),
        "mvn_full": (JMVN.create(10, mean=mean, cov=cov),
                     "MultivariateNormal",
                     ("mean", "cov", "cov_inv", "chol", "log_norm_const",
                      "iso")),
    }


@pytest.mark.parametrize("case", ["rosenbrock30", "mvn_iso", "mvn_full"])
def test_log_density_td_matches_jax(case):
    jt, name, names = _jax_targets()[case]
    pt = target_from_numpy(name, _fields(jt, names), device="cpu")
    assert pt.dim == jt.dim
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(jt.dim, 6, 64)) * 1.3).astype(np.float32)
    ref = np.asarray(jt.log_density_td(jnp.asarray(x)))
    ours = pt.log_density_td(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    xb = np.moveaxis(x[:, 0], 0, -1)                      # (C, d)
    np.testing.assert_allclose(pt.log_density(torch.from_numpy(xb)).numpy(),
                               np.asarray(jt.log_density(jnp.asarray(xb))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["rosenbrock30", "mvn_iso", "mvn_full"])
def test_create_matches_jax_fields(case):
    """The port's constructors build the JAX package's parameters."""
    jt, name, names = _jax_targets()[case]
    if name == "FullRosenbrock":
        ours = FullRosenbrock.create(30, device="cpu")
    else:
        cov = None if jt.iso else np.asarray(jt.cov)
        ours = MultivariateNormal.create(10, mean=np.asarray(jt.mean),
                                         cov=cov, device="cpu")
    assert ours.name == name
    for k in names:
        np.testing.assert_allclose(np.asarray(getattr(ours, k), np.float32),
                                   np.asarray(getattr(jt, k), np.float32),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_init_sample_and_direct_sample():
    g = torch.Generator().manual_seed(0)
    t = MultivariateNormal.create(3, mean=[1.0, -2.0, 0.5],
                                  cov=np.diag([1.0, 4.0, 0.25]),
                                  device="cpu")
    x0 = t.init_sample(5, g)
    assert x0.shape == (5, 3) and float(x0.abs().max()) < 1e-6
    s = t.direct_sample(200_000, beta=0.25, generator=g).numpy()
    np.testing.assert_allclose(s.mean(0), [1.0, -2.0, 0.5], atol=0.03)
    np.testing.assert_allclose(s.var(0), np.array([1.0, 4.0, 0.25]) / 0.25,
                               rtol=0.02)
    with pytest.raises(NotImplementedError):
        FullRosenbrock.create(4, device="cpu").direct_sample(3)


def test_normal_proposal_matches_jax():
    jp = JNormalProposal.create(6, 0.7)
    pp = proposal_from_numpy(
        "Normal", {"base_variance_scalar": np.asarray(jp.base_variance_scalar)},
        dim=6, device="cpu")
    assert float(pp.base_variance_scalar) == pytest.approx(0.7)
    betas = np.array([1.0, 0.5, 0.1], np.float32)
    inc = np.random.default_rng(2).normal(size=(6, 3, 9)).astype(np.float32)
    ref = np.asarray(jp.log_inc_density(jnp.asarray(inc), jnp.asarray(betas)))
    ours = pp.log_inc_density(torch.from_numpy(inc), torch.from_numpy(betas))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert float(pp.log_q_ratio(torch.from_numpy(inc),
                                torch.from_numpy(betas)).abs().max()) == 0.0
    # variance / beta law of the increments
    z = pp.sample_td(torch.Generator().manual_seed(1), torch.from_numpy(betas),
                     (3, 40_000))
    np.testing.assert_allclose(z.var(dim=(0, 2)).numpy(), 0.7 / betas,
                               rtol=0.02)
    jz = np.asarray(jp.sample_td(jax.random.key(0), jnp.asarray(betas),
                                 (3, 40_000)))
    np.testing.assert_allclose(jz.var(axis=(0, 2)), 0.7 / betas, rtol=0.02)
    assert NormalProposal.create(6, 0.7, device="cpu").sample(
        4, 0.5, torch.Generator().manual_seed(0)).shape == (4, 6)


def test_x64_switch():
    """``set_x64`` makes new targets, proposals and eager states float64;
    the default is float32."""
    from rwm_pt_tpu_torch.kernels import run_rwm
    assert default_float() == torch.float32
    set_x64(True)
    try:
        t = MultivariateNormal.create(2, device="cpu")
        p = NormalProposal.create(2, 1.0, device="cpu")
        r = run_rwm(t, p, 0, num_chains=4, num_iterations=3, device="cpu")
        assert t.mean.dtype == p.base_variance_scalar.dtype == torch.float64
        assert r.state.x.dtype == r.state.logp.dtype == torch.float64
    finally:
        set_x64(False)
    assert MultivariateNormal.create(2, device="cpu").mean.dtype == \
        torch.float32
