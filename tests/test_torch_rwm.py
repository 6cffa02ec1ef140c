"""The port's RWM engines (eager run_rwm, fused run_rwm_fused) against the
JAX package: step for step against the Pallas PT body at T=1 with no swaps
(the MH body of pallas_rwm.py:293-312) on shared draws, for the Normal,
Laplace and UniformRadius increments and the recorded trace, bookkeeping
and trace shapes against run_rwm_pallas, rates and trace moments against
the scan engine, exact invariance, and resume."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (Z_MAX, f32_sigmas, invariance_max_z,
                                 make_draws, make_proposal_draws, rate_z,
                                 run_jax_body)
from rwm_pt_tpu.kernels import RWMState as JRWMState
from rwm_pt_tpu.kernels import run_rwm as jrun_rwm
from rwm_pt_tpu.kernels import run_rwm_pallas
from rwm_pt_tpu.proposals import NormalProposal as JNormalProposal
from rwm_pt_tpu.targets import FullRosenbrock as JFullRosenbrock
from rwm_pt_tpu.targets import MultivariateNormal as JMVN
from rwm_pt_tpu_torch.convert import (rwm_state_from_numpy,
                                      rwm_state_to_numpy, target_from_numpy)
from rwm_pt_tpu_torch.kernels import RWMState, run_rwm, run_rwm_fused
from rwm_pt_tpu_torch.kernels.fused_rwm import proposal_scale
from rwm_pt_tpu_torch.proposals import (LaplaceProposal, NormalProposal,
                                        UniformRadiusProposal)
from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("kind,d,S,burn_in,step0,beta,base", [
    ("rosenbrock", 7, 30, 5, 0, 1.0, 0.5 ** 2 / 7),
    ("mvn", 5, 30, 10, 9, 0.5, 1.4),
], ids=["rosenbrock-fresh", "mvn-resume-tempered"])
def test_fused_plain_matches_pallas_body(monkeypatch, kind, d, S, burn_in,
                                         step0, beta, base):
    if kind == "rosenbrock":
        jt = JFullRosenbrock.create(d)
        pt = target_from_numpy("FullRosenbrock", {
            k: np.asarray(getattr(jt, k)) for k in ("a_coeff", "b_coeff",
                                                    "mu")}, device=CPU)
    else:
        jt = JMVN.create(d)
        pt = target_from_numpy("MultivariateNormal", {
            k: np.asarray(getattr(jt, k)) for k in (
                "mean", "cov", "cov_inv", "chol", "log_norm_const", "iso")},
            device=CPU)
    C = 24
    rng = np.random.default_rng(d)
    x0 = (rng.normal(size=(d, C)) * 0.7).astype(np.float32)
    acc0 = rng.integers(0, 20, C).astype(np.int32)
    jump0 = (rng.random(C) * 5).astype(np.float32)
    normals, u_mh, _ = make_draws(17, S, 1, d, C)
    # the PT body at T=1 with swap_every beyond the run is the RWM body
    betas = np.asarray([beta], np.float32)
    ref = run_jax_body(monkeypatch, jt, x0[:, None], betas,
                       f32_sigmas(base, betas), (normals, u_mh, u_mh[:, :0]),
                       step0, burn_in, 10 ** 6, acc0[None], None, None,
                       jump0)
    state = rwm_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, sum_sq_jump=jump0, step=step0), device=CPU)
    r = run_rwm_fused(pt, 0, base_variance=base, beta=beta, num_chains=C,
                      num_iterations=S, burn_in=burn_in, resume_state=state,
                      device=CPU, draws=(torch.from_numpy(normals[:, 0]),
                                         torch.from_numpy(u_mh[:, 0])))
    st = r.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2][0])
    np.testing.assert_allclose(st.x.numpy(), ref[0][:, 0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1][0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump.numpy(), ref[5], rtol=RTOL,
                               atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()
    assert st.step == step0 + S


def test_wrapper_bookkeeping_matches_pallas():
    key = jax.random.key(0)
    kw = dict(base_variance=0.5, num_chains=16, num_iterations=30,
              burn_in=10)
    jr = run_rwm_pallas(JMVN.create(3), key, **kw, interpret=True)
    jr2 = run_rwm_pallas(JMVN.create(3), key, **dict(kw, num_iterations=12),
                         resume_state=jr.state, interpret=True)
    pt = MultivariateNormal.create(3, device=CPU)
    r = run_rwm_fused(pt, 0, **kw, device=CPU)
    r2 = run_rwm_fused(pt, 0, **dict(kw, num_iterations=12),
                       resume_state=r.state, device=CPU)
    for j, p in ((jr, r), (jr2, r2)):
        assert p.state.step == int(j.state.step)
        assert tuple(p.state.x.shape) == tuple(j.state.x.shape)
        assert tuple(p.acceptance_rate.shape) == tuple(j.acceptance_rate.shape)
        assert tuple(p.esjd.shape) == tuple(j.esjd.shape)


@pytest.mark.parametrize("name,d,var,C", [
    ("mvn", 10, 2.38 ** 2 / 10, 2048),
    ("rosenbrock", 30, 0.5 ** 2 / 30, 1024),
], ids=["mvn10", "rosenbrock30"])
def test_rates_match_jax_scan(name, d, var, C):
    """Eager and fused-plain acceptance rate and ESJD against JAX run_rwm:
    within 5 Monte-Carlo standard errors."""
    if name == "mvn":
        jt, pt = JMVN.create(d), MultivariateNormal.create(d, device=CPU)
    else:
        jt, pt = JFullRosenbrock.create(d), FullRosenbrock.create(d,
                                                                  device=CPU)
    kw = dict(num_chains=C, num_iterations=300, burn_in=50)
    jr = jrun_rwm(jt, JNormalProposal.create(d, var), jax.random.key(1), **kw)
    eager = run_rwm(pt, NormalProposal.create(d, var, device=CPU), 2,
                    device=CPU, **kw)
    fused = run_rwm_fused(pt, 3, base_variance=var, device=CPU, **kw)
    for label, r in (("eager", eager), ("fused", fused)):
        assert rate_z(r.acceptance_rate.numpy(),
                      np.asarray(jr.acceptance_rate)) < 5, label
        assert rate_z(r.esjd.numpy(), np.asarray(jr.esjd)) < 5, label


@pytest.mark.parametrize("engine", ["eager", "fused"])
def test_rwm_invariance(engine):
    d, C = 4, 4096
    target = MultivariateNormal.create(d, device=CPU)
    g = torch.Generator().manual_seed(7 + len(engine))
    exact = target.direct_sample(C, 1.0, g).T
    kw = dict(num_chains=C, num_iterations=40, burn_in=0, init_states=exact,
              device=CPU)
    if engine == "fused":
        r = run_rwm_fused(target, 5, base_variance=1.4, **kw)
    else:
        r = run_rwm(target, NormalProposal.create(d, 1.4, device=CPU), 5,
                    **kw)
    assert float(r.acceptance_rate.mean()) > 0.01
    z = invariance_max_z(r.state.x, target.direct_sample(C, 1.0, g).T,
                         target)
    assert z < Z_MAX, (engine, z)


@pytest.mark.parametrize("engine", ["eager", "fused"])
def test_resume_equals_uninterrupted(engine):
    target = FullRosenbrock.create(6, device=CPU)
    kw = dict(num_chains=32, burn_in=4, device=CPU)
    if engine == "fused":
        def run(n, resume=None):
            return run_rwm_fused(target, 13, base_variance=0.05,
                                 num_iterations=n, resume_state=resume, **kw)
    else:
        prop = NormalProposal.create(6, 0.05, device=CPU)

        def run(n, resume=None):
            return run_rwm(target, prop, 13, num_iterations=n,
                           resume_state=resume, **kw)
    whole = run(40)
    b = run(25, run(15).state)
    for f in ("x", "logp", "accept_count"):
        assert torch.equal(getattr(whole.state, f), getattr(b.state, f)), f
    np.testing.assert_allclose(b.state.sum_sq_jump.numpy(),
                               whole.state.sum_sq_jump.numpy(), rtol=1e-6)
    assert b.state.step == whole.state.step == 44


def test_checkpoint_round_trip_with_jax():
    jt = JMVN.create(3)
    jr = jrun_rwm(jt, JNormalProposal.create(3, 1.0), jax.random.key(4),
                  num_chains=32, num_iterations=20, burn_in=5)
    st = rwm_state_from_numpy({f.name: np.asarray(getattr(jr.state, f.name))
                               for f in dataclasses.fields(RWMState)},
                              device=CPU)
    r = run_rwm_fused(MultivariateNormal.create(3, device=CPU), 1,
                      base_variance=1.0, num_chains=32, num_iterations=10,
                      burn_in=5, resume_state=st, device=CPU)
    assert r.state.step == 35
    back = JRWMState(**{k: jnp.asarray(v)
                        for k, v in rwm_state_to_numpy(r.state).items()})
    jr2 = jrun_rwm(jt, JNormalProposal.create(3, 1.0), jax.random.key(5),
                   num_chains=32, num_iterations=5, burn_in=5,
                   resume_state=back)
    assert int(jr2.state.step) == 40
    assert (np.asarray(jr2.state.accept_count)
            >= r.state.accept_count.numpy()).all()


def test_record_every_shapes():
    r = run_rwm(MultivariateNormal.create(2, device=CPU),
                NormalProposal.create(2, 1.0, device=CPU), 0, num_chains=8,
                num_iterations=17, burn_in=3, record_every=5, record_chains=3,
                device=CPU)
    assert r.chain.shape == (4, 2, 3)
    assert torch.equal(r.chain[-1], r.state.x[:, :3])


def _targets(kind, d):
    if kind == "rosenbrock":
        jt = JFullRosenbrock.create(d)
        return jt, target_from_numpy("FullRosenbrock", {
            k: np.asarray(getattr(jt, k)) for k in ("a_coeff", "b_coeff",
                                                    "mu")}, device=CPU)
    jt = JMVN.create(d)
    return jt, target_from_numpy("MultivariateNormal", {
        k: np.asarray(getattr(jt, k)) for k in (
            "mean", "cov", "cov_inv", "chol", "log_norm_const", "iso")},
        device=CPU)


@pytest.mark.parametrize("prop,kind,beta,record_every", [
    ("Laplace", "rosenbrock", 1.0, 0),
    ("Laplace", "mvn", 0.5, 7),
    ("UniformRadius", "rosenbrock", 1.0, 0),
    ("UniformRadius", "mvn", 0.5, 7),
], ids=["laplace-rb", "laplace-mvn-tempered-record",
        "uniform_radius-rb", "uniform_radius-mvn-tempered-record"])
def test_fused_plain_new_proposals_match_pallas_body(monkeypatch, prop, kind,
                                                     beta, record_every):
    """Laplace (anisotropic scales sqrt(v / beta / 2)) and UniformRadius
    (radius R / sqrt(beta)) step for step against the Pallas MH body with
    the kernel's own increments on shared draws: counts exact, floats to
    rtol 1e-5.  The recorded cases hold entry k of the trace against the
    body's state after step (k+1) * record_every (30 = 4 * 7 + 2: two
    trailing steps unrecorded)."""
    d, C, S, burn_in, step0 = 5, 24, 30, 5, 9
    jt, pt = _targets(kind, d)
    rng = np.random.default_rng(len(prop) + d)
    x0 = (rng.normal(size=(d, C)) * 0.7).astype(np.float32)
    acc0 = rng.integers(0, 20, C).astype(np.int32)
    jump0 = (rng.random(C) * 5).astype(np.float32)
    if prop == "Laplace":
        vec = np.linspace(0.02, 0.1, d) if kind == "rosenbrock" else 1.4
        p = LaplaceProposal.create(d, vec, device=CPU)
    else:
        p = UniformRadiusProposal.create(
            d, 0.5 if kind == "rosenbrock" else 2.4, device=CPU)
    _, scale = proposal_scale(p, None, torch.tensor(beta))
    draws = make_proposal_draws(17, prop, S, 1, d, C)
    snaps = []
    ref = run_jax_body(monkeypatch, jt, x0[:, None], np.float32([beta]),
                       scale.numpy()[None], (*draws[:2], draws[2][:, :0],
                                             *draws[3:]),
                       step0, burn_in, 10 ** 6, acc0[None], None, None,
                       jump0, kind=prop, snapshots=snaps)
    state = rwm_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, sum_sq_jump=jump0, step=step0), device=CPU)
    inj = [torch.from_numpy(draws[0][:, 0]), torch.from_numpy(draws[1][:, 0])]
    if prop == "UniformRadius":
        inj.append(torch.from_numpy(draws[3][:, 0]))
    r = run_rwm_fused(pt, 0, proposal=p, beta=beta, num_chains=C,
                      num_iterations=S, burn_in=burn_in, resume_state=state,
                      record_every=record_every or None, record_chains=3,
                      device=CPU, draws=tuple(inj))
    st = r.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2][0])
    np.testing.assert_allclose(st.x.numpy(), ref[0][:, 0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1][0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump.numpy(), ref[5], rtol=RTOL,
                               atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()
    if record_every:
        want = np.stack([snaps[(k + 1) * record_every - 1][:, :3]
                         for k in range(S // record_every)])
        assert tuple(r.chain.shape) == (S // record_every, d, 3)
        np.testing.assert_allclose(r.chain.numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    else:
        assert r.chain is None


def test_record_shapes_match_pallas():
    """Trace shape and step count of a recorded run against
    ``run_rwm_pallas(record_every=..., interpret=True)`` and the eager
    engine; a ``record_every`` beyond the run raises on both packages."""
    kw = dict(base_variance=0.5, num_chains=16, num_iterations=26,
              burn_in=4, record_every=8, record_chains=5)
    jr = run_rwm_pallas(JMVN.create(3), jax.random.key(0), **kw,
                        interpret=True)
    pt = MultivariateNormal.create(3, device=CPU)
    r = run_rwm_fused(pt, 0, **kw, device=CPU)
    e = run_rwm(pt, NormalProposal.create(3, 0.5, device=CPU), 0,
                **{k: v for k, v in kw.items() if k != "base_variance"},
                device=CPU)
    assert tuple(jr.chain.shape) == (30 // 8, 3, 5)
    for res in (r, e):
        assert tuple(res.chain.shape) == tuple(jr.chain.shape)
        assert res.state.step == int(jr.state.step) == 30
    with pytest.raises(ValueError, match="record_every"):
        run_rwm_pallas(JMVN.create(3), jax.random.key(0),
                       **dict(kw, record_every=31), interpret=True)
    with pytest.raises(ValueError, match="record_every"):
        run_rwm_fused(pt, 0, **dict(kw, record_every=31), device=CPU)


@pytest.mark.parametrize("prop", ["Normal", "Laplace", "UniformRadius"])
def test_trace_moments_match_jax_scan(prop):
    """Traces of the fused plain version and the eager engine against the
    JAX scan engine's, for each proposal, on MVN d=2 (the same proposal
    built by both factories): the coordinates' first and second moments
    within 5 Monte-Carlo standard errors (per-chain averages, chains
    independent)."""
    from rwm_pt_tpu.proposals import create_proposal_distribution as jcreate
    from rwm_pt_tpu_torch.proposals import create_proposal_distribution
    d, C = 2, 256
    params = {"Normal": {"base_variance_scalar": 2.0},
              "Laplace": {"base_variance_vector": 2.0},
              "UniformRadius": {"base_radius": 2.5}}[prop]
    cfg = {"name": prop, "params": params}
    kw = dict(num_chains=C, num_iterations=240, burn_in=60, record_every=4,
              record_chains=C)
    jr = jrun_rwm(JMVN.create(d), jcreate(d, cfg), jax.random.key(6), **kw)
    pt = MultivariateNormal.create(d, device=CPU)
    p = create_proposal_distribution(d, cfg, device=CPU)
    fused = run_rwm_fused(pt, 7, proposal=p, device=CPU, **kw)
    eager = run_rwm(pt, p, 8, device=CPU, **kw)
    ref = np.asarray(jr.chain)
    for label, r in (("fused", fused), ("eager", eager)):
        assert tuple(r.chain.shape) == ref.shape == (75, d, C)
        zs = []
        for f in (lambda x: x, np.square):
            ma = f(r.chain.numpy().astype(np.float64)[15:]).mean(0)
            mb = f(ref.astype(np.float64)[15:]).mean(0)
            zs += [rate_z(ma[i], mb[i]) for i in range(d)]
        assert max(zs) < 5, (label, zs)
        assert rate_z(r.acceptance_rate.numpy(),
                      np.asarray(jr.acceptance_rate)) < 5, label
