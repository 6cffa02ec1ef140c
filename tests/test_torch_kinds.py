"""The port's other targets (every registry name but SuperFunnel, which
tests/test_torch_super_funnel.py holds) against
the JAX package's, on the same numpy inputs: log-densities, the registry's
constructors and Scaled factors bit for bit, the fused PT and RWM plain
versions step for step against the Pallas body on shared draws, the exact
tempered samplers' moments, initial states and marginals, and every
registry name through both fused samplers on the CPU plain path."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import f32_sigmas, make_draws, rate_z, run_jax_body
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.convert import (pt_state_from_numpy,
                                      rwm_state_from_numpy,
                                      target_from_numpy, target_to_numpy)
from rwm_pt_tpu_torch.kernels import _build, run_pt_fused, run_rwm_fused
from rwm_pt_tpu_torch.kernels.draws import ProbeStream, seed_key
from rwm_pt_tpu_torch.targets import (PORTED_TARGETS, RoughCarpet,
                                      ScaledMultivariateNormal, ThreeMixture)
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def _spd(d, seed=5):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return (a @ a.T / d + np.eye(d)).astype(np.float32)


# case -> (registry name, registry kwargs, dim, kernel kind, Normal variance)
CASES = {
    "mvn_full": ("MultivariateNormal", {"cov": _spd(6)}, 6, "mvn_full", 1.0),
    "scaled_mvn": ("MultivariateNormalScaled", {"seed": 3}, 6, "scaled_mvn",
                   0.3),
    "three_mixture": ("ThreeMixture", {}, 6, "three_mixture", 1.0),
    "three_mixture_scaled_pt": ("ThreeMixtureScaled", {"variant": "pt_gpu"},
                                6, "three_mixture", 1.0),
    "rough_carpet": ("RoughCarpet", {}, 5, "rough_carpet", 0.8),
    "rough_carpet_scaled": ("RoughCarpetScaled", {"seed": 2}, 5,
                            "rough_carpet", 0.8),
    "even_rosenbrock": ("EvenRosenbrock", {}, 6, "even_rosenbrock", 0.05),
    "hybrid_rosenbrock": ("HybridRosenbrock", {"n1": 3, "n2": 3}, 7,
                          "hybrid_rosenbrock", 0.01),
    "hypercube": ("Hypercube", {}, 5, "hypercube", 0.1),
    "iid_gamma": ("IIDGamma", {}, 5, "iid_gamma", 3.0),
    "iid_beta": ("IIDBeta", {}, 5, "iid_beta", 0.02),
    "neal_funnel": ("NealFunnel", {}, 5, "neal_funnel", 0.8),
}


def _pair(case):
    """(JAX target, the port's target built from its fields, variance)."""
    name, kw, d, _, var = CASES[case]
    jt = jget(name, d, **kw)
    fields = {f.name: (np.asarray(getattr(jt, f.name))
                       if isinstance(getattr(jt, f.name), jax.Array)
                       else getattr(jt, f.name))
              for f in dataclasses.fields(jt)}
    return jt, target_from_numpy(type(jt).__name__, fields, device=CPU), var


def _points(case, d, shape, seed):
    """Points (d, *shape) around the support, some outside it."""
    rng = np.random.default_rng(seed)
    if case == "iid_gamma":
        x = rng.gamma(2.0, 3.0, (d,) + shape) - 0.3
    elif case == "iid_beta":
        x = rng.uniform(-0.05, 1.05, (d,) + shape)
    elif case == "hypercube":
        x = rng.uniform(-1.15, 1.15, (d,) + shape)
    elif case.startswith("three_mixture"):
        x = rng.normal(size=(d,) + shape) * 3.0
    else:
        x = rng.normal(size=(d,) + shape) * 1.3
    return x.astype(np.float32)


def _start(case, jt, shape, seed):
    """Starting states inside the support (JAX's own initial states plus a
    jitter for the targets that start at the origin)."""
    n = int(np.prod(shape))
    x = np.asarray(jt.init_sample(jax.random.key(seed), n)).T
    if case.startswith(("three_mixture", "rough_carpet")):
        x = x + np.random.default_rng(seed).normal(size=x.shape)
    return x.reshape((jt.dim,) + shape).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_log_density_matches_jax(case):
    jt, pt, _ = _pair(case)
    assert pt.dim == jt.dim and pt.get_name() == jt.get_name()
    x = _points(case, jt.dim, (4, 33), zlib.crc32(case.encode()))
    ref = np.asarray(jt.log_density_td(jnp.asarray(x)))
    ours = pt.log_density_td(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-5)
    assert np.isfinite(ref).any()
    xb = np.moveaxis(x[:, 0], 0, -1)
    np.testing.assert_allclose(pt.log_density(torch.from_numpy(xb)).numpy(),
                               np.asarray(jt.log_density(jnp.asarray(xb))),
                               rtol=RTOL, atol=1e-5)
    assert _build.kernel_target(pt)[0] == CASES[case][3]


@pytest.mark.parametrize("case", list(CASES))
def test_registry_builds_the_jax_fields(case):
    """``get_target_distribution`` with the JAX registry's arguments builds
    the JAX fields (Scaled factors bit for bit), and ``target_to_numpy``
    carries every field back."""
    name, kw, d, _, _ = CASES[case]
    jt = jget(name, d, **kw)
    tt = tget(name, d, device=CPU, **kw)
    assert tt.name == jt.name and tt.dim == jt.dim
    for k, v in target_to_numpy(tt).items():
        want = getattr(jt, k)
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(v, np.asarray(want), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        else:
            assert v == want, k
    if hasattr(jt, "scaling_factors"):
        np.testing.assert_array_equal(tt.scaling_factors.numpy(),
                                      np.asarray(jt.scaling_factors))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("d", [3, 10, 30])
def test_scaled_factors_bit_for_bit(seed, d):
    from rwm_pt_tpu.targets import RoughCarpet as JRC
    from rwm_pt_tpu.targets import ScaledMultivariateNormal as JSMVN
    from rwm_pt_tpu.targets import ThreeMixture as JTM
    pairs = [(ScaledMultivariateNormal.create(d, seed=seed, device=CPU),
              JSMVN.create(d, seed=seed)),
             (ThreeMixture.create(d, scaling=True, seed=seed, device=CPU),
              JTM.create(d, scaling=True, seed=seed)),
             (RoughCarpet.create(d, scaling=True, seed=seed, device=CPU),
              JRC.create(d, scaling=True, seed=seed))]
    for ours, theirs in pairs:
        np.testing.assert_array_equal(ours.scaling_factors.numpy(),
                                      np.asarray(theirs.scaling_factors))


def _states(rng, T, C):
    return (rng.integers(0, 50, (T, C)).astype(np.int32),
            rng.integers(0, 50, C).astype(np.int32),
            rng.random(C).astype(np.float32) * 3,
            rng.random(C).astype(np.float32) * 7)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_pt_plain_matches_pallas_body(monkeypatch, case):
    """The plain fused PT version step for step against ``_pt_body_fn`` on
    shared draws: counters exact, floats to rtol 1e-5."""
    jt, pt, var = _pair(case)
    d, T, C, S = jt.dim, 4, 16, 24
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    betas = np.geomspace(1.0, 0.1, T).astype(np.float32)
    x0 = _start(case, jt, (T, C), 3)
    acc0, swapacc0, bj0, cj0 = _states(rng, T, C)
    draws = make_draws(11, S, T, d, C)
    ref = run_jax_body(monkeypatch, jt, x0, betas, f32_sigmas(var, betas),
                       draws, 0, 4, 3, acc0, swapacc0, bj0, cj0)
    state = pt_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, swap_attempt_count=0, swap_accept_count=swapacc0,
        sum_beta_sq_jump=bj0, sum_sq_jump_cold=cj0, step=0), device=CPU)
    res = run_pt_fused(pt, 0, betas, base_variance=var, num_chains=C,
                       num_iterations=S, burn_in=4, swap_every=3,
                       resume_state=state, device=CPU,
                       draws=tuple(torch.from_numpy(a) for a in draws))
    st = res.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2])
    np.testing.assert_array_equal(st.swap_accept_count.numpy(), ref[3])
    np.testing.assert_allclose(st.x.numpy(), ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(st.sum_beta_sq_jump.numpy(), ref[4],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()
    assert (st.swap_accept_count.numpy() > swapacc0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_fused_rwm_plain_matches_pallas_body(monkeypatch, case):
    """The plain fused RWM version step for step against the Pallas body at
    T=1 with no swaps (the RWM kernel's MH body)."""
    jt, pt, var = _pair(case)
    d, C, S = jt.dim, 24, 24
    rng = np.random.default_rng(zlib.crc32(case.encode()) + 1)
    x0 = _start(case, jt, (C,), 4)
    acc0 = rng.integers(0, 20, C).astype(np.int32)
    jump0 = (rng.random(C) * 5).astype(np.float32)
    normals, u_mh, _ = make_draws(17, S, 1, d, C)
    betas = np.ones(1, np.float32)
    ref = run_jax_body(monkeypatch, jt, x0[:, None], betas,
                       f32_sigmas(var, betas), (normals, u_mh, u_mh[:, :0]),
                       0, 5, 10 ** 6, acc0[None], None, None, jump0)
    state = rwm_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, sum_sq_jump=jump0, step=0), device=CPU)
    r = run_rwm_fused(pt, 0, base_variance=var, num_chains=C,
                      num_iterations=S, burn_in=5, resume_state=state,
                      device=CPU, draws=(torch.from_numpy(normals[:, 0]),
                                         torch.from_numpy(u_mh[:, 0])))
    st = r.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2][0])
    np.testing.assert_allclose(st.x.numpy(), ref[0][:, 0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1][0], rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(st.sum_sq_jump.numpy(), ref[5], rtol=RTOL,
                               atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()


# tempered exact samplers; the funnel is the soft one of
# tests/test_invariance.py (sigma_v^2 = 0.5), whose moments stay finite
SAMPLER_CASES = {
    "mvn_iso": ("MultivariateNormal", {}, 4),
    "mvn_full": ("MultivariateNormal", {"cov": _spd(4)}, 4),
    "scaled_mvn": ("MultivariateNormalScaled", {"seed": 3}, 4),
    "three_mixture": ("ThreeMixtureScaled", {}, 4),
    "rough_carpet": ("RoughCarpetScaled", {}, 3),
    "even_rosenbrock": ("EvenRosenbrock", {}, 4),
    "hybrid_rosenbrock": ("HybridRosenbrock", {"n1": 3, "n2": 2}, 5),
    "hypercube": ("Hypercube", {}, 4),
    "iid_gamma": ("IIDGamma", {}, 4),
    "iid_beta": ("IIDBeta", {}, 4),
    "neal_funnel": ("NealFunnel", {"sigma_v_sq": 0.5}, 4),
}


@pytest.mark.parametrize("sampler", ["direct", "stream"])
@pytest.mark.parametrize("beta", [1.0, 0.3])
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_direct_sample_moments_match_jax(case, beta, sampler):
    """First and second moments of 20,000 tempered exact draws per
    coordinate, the port's against the JAX sampler's: z < 5.  The port's
    draws come from ``direct_sample`` with a generator, or from
    ``stream_sample`` on one side of a ladder probe, the draws of the
    iterative ladder builders and their kernel."""
    name, kw, d = SAMPLER_CASES[case]
    jt, tt = jget(name, d, **kw), tget(name, d, device=CPU, **kw)
    n = 20000
    s = zlib.crc32(case.encode())
    if sampler == "direct":
        g = torch.Generator().manual_seed(s)
        ours = tt.direct_sample(n, beta, g)
    else:
        ours = tt.stream_sample(ProbeStream(seed_key(s), 1, 0, n, "cpu"), n,
                                torch.tensor(beta, dtype=torch.float32))
    ours = ours.double().numpy()
    theirs = np.asarray(jt.direct_sample(jax.random.key(1), n, beta),
                        np.float64)
    assert ours.shape == theirs.shape == (n, jt.dim)
    for f in (lambda v: v, np.square):
        for i in range(jt.dim):
            assert rate_z(f(ours[:, i]), f(theirs[:, i])) < 5, (case, i)


def test_init_samples():
    """The per-target initial states of the JAX package: the multimodal
    targets at the origin, IIDGamma at 5 + 0.01 N, IIDBeta in U(0.2, 0.8),
    Hypercube at 20-80 % of the box."""
    g = torch.Generator().manual_seed(0)
    for name in ("ThreeMixture", "RoughCarpetScaled"):
        assert torch.equal(tget(name, 4, device=CPU).init_sample(5, g),
                           torch.zeros(5, 4))
    x = tget("IIDGamma", 4, device=CPU).init_sample(4000, g)
    assert abs(float(x.mean()) - 5.0) < 1e-3
    assert abs(float(x.std()) - 0.01) < 1e-3
    x = tget("IIDBeta", 4, device=CPU).init_sample(4000, g)
    assert float(x.min()) >= 0.2 and float(x.max()) <= 0.8
    x = tget("Hypercube", 4, device=CPU).init_sample(4000, g)   # (-1, 1)
    assert float(x.min()) >= -0.6 and float(x.max()) <= 0.6
    assert float(x.std()) > 0.3


@pytest.mark.parametrize("case", ["mvn_full", "scaled_mvn", "three_mixture",
                                  "rough_carpet_scaled", "hypercube",
                                  "iid_gamma", "iid_beta", "neal_funnel"])
def test_marginal_density_matches_jax(case):
    jt, pt, _ = _pair(case)
    xs = np.linspace(-6.0, 8.0, 57).astype(np.float32)
    for axis in (0, jt.dim - 1):
        np.testing.assert_allclose(
            pt.marginal_density(axis, xs).numpy(),
            np.asarray(jt.marginal_density(axis, jnp.asarray(xs))),
            rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("name", PORTED_TARGETS)
def test_every_registry_name_runs_fused_on_cpu(name):
    """Every ported registry name builds and runs through both fused
    samplers on the CPU plain path: finite log-densities, but SuperFunnel's
    -inf exactly where a tau is at most 1e-9 (most chains of its default
    initial states 1e-8 N(0, 1) start there)."""
    t = tget(name, 4, device=CPU)
    kind, params = _build.kernel_target(t)
    assert kind in _build.TARGET_KINDS and params.dtype == torch.float32
    assert _build.target_kind(t) == kind
    r = run_rwm_fused(t, 1, base_variance=0.05, num_chains=6,
                      num_iterations=5, device=CPU)
    p = run_pt_fused(t, 2, [1.0, 0.5], base_variance=0.05, num_chains=6,
                     num_iterations=5, swap_every=2, device=CPU)
    for res in (r, p):
        assert torch.isfinite(res.state.x).all()
        if name == "SuperFunnel":
            tau = res.state.x[-2:]
            assert torch.equal(torch.isfinite(res.state.logp),
                               ((tau > 1e-9).all(0)))
        else:
            assert torch.isfinite(res.state.logp).all()
        assert res.state.step == 5


def test_launch_counts_sum_by_variant():
    """The wrappers count launches under ``<variant>.<kind>``;
    ``by_variant`` sums them by variant and passes the record keys on."""
    from collections import Counter
    seen = Counter({"fused_pt_bm.three_mixture": 2, "fused_pt_bm.rosenbrock": 1,
                    "fused_pt.rosenbrock": 4, "fused_pt_record": 1})
    assert _build.by_variant(seen) == Counter(
        {"fused_pt_bm": 3, "fused_pt": 4, "fused_pt_record": 1})
    assert _build.target_kind(object()) is None
