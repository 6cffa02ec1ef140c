"""The port's PT engines (eager run_pt, fused run_pt_fused) against the JAX
package: step for step against the Pallas kernel's own body on shared
draws (Normal, Laplace, UniformRadius; traces of the cold rung after the
swap sweep), bookkeeping and trace shapes against run_pt_pallas, rates and
trace moments against the scan engine, exact invariance per rung, resume
and checkpoints."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (Z_MAX, f32_sigmas, invariance_max_z,
                                 make_draws, make_proposal_draws, rate_z,
                                 run_jax_body)
from rwm_pt_tpu.kernels import PTState as JPTState
from rwm_pt_tpu.kernels import run_pt as jrun_pt
from rwm_pt_tpu.kernels import run_pt_pallas
from rwm_pt_tpu.proposals import NormalProposal as JNormalProposal
from rwm_pt_tpu.targets import FullRosenbrock as JFullRosenbrock
from rwm_pt_tpu.targets import MultivariateNormal as JMVN
from rwm_pt_tpu_torch.convert import (pt_state_from_numpy, pt_state_to_numpy,
                                      target_from_numpy)
from rwm_pt_tpu_torch.kernels import PTState, run_pt, run_pt_fused
from rwm_pt_tpu_torch.kernels import _build
from rwm_pt_tpu_torch.kernels.fused_pt import rung_scales
from rwm_pt_tpu_torch.proposals import (LaplaceProposal, NormalProposal,
                                        UniformRadiusProposal)
from rwm_pt_tpu_torch.targets import FullRosenbrock, MultivariateNormal

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def _jax_target(kind, d):
    if kind == "rosenbrock":
        jt = JFullRosenbrock.create(d)
        names = ("a_coeff", "b_coeff", "mu")
        name = "FullRosenbrock"
    else:
        cov = None
        if kind == "mvn_full":
            a = np.random.default_rng(5).normal(size=(d, d))
            cov = (a @ a.T / d + np.eye(d)).astype(np.float32)
        jt = JMVN.create(d, cov=cov)
        names = ("mean", "cov", "cov_inv", "chol", "log_norm_const", "iso")
        name = "MultivariateNormal"
    fields = {k: np.asarray(getattr(jt, k)) for k in names}
    return jt, target_from_numpy(name, fields, device=CPU)


# (target, d, T, C, steps, burn_in, swap_every, step0, base variance)
BODY_CASES = [
    ("rosenbrock", 6, 4, 16, 30, 5, 5, 0, 0.5 ** 2 / 6),
    ("rosenbrock", 6, 4, 16, 30, 3, 7, 0, 0.5 ** 2 / 6),
    ("mvn_iso", 5, 4, 16, 30, 10, 4, 12, 1.4),
    ("mvn_full", 4, 3, 16, 25, 2, 3, 0, 1.0),
]


@pytest.mark.parametrize("case", BODY_CASES,
                         ids=["rb-divides", "rb-not-dividing", "mvn-resume",
                              "mvn-fullcov"])
def test_fused_plain_matches_pallas_body(monkeypatch, case):
    kind, d, T, C, S, burn_in, swap_every, step0, base = case
    jt, pt = _jax_target(kind, d)
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    betas = np.geomspace(1.0, 0.05, T).astype(np.float32)
    x0 = (rng.normal(size=(d, T, C)) * 0.5).astype(np.float32)
    draws = make_draws(11, S, T, d, C)
    acc0 = rng.integers(0, 50, (T, C)).astype(np.int32)
    swapacc0 = rng.integers(0, 50, C).astype(np.int32)
    bj0 = rng.random(C).astype(np.float32) * 3
    cj0 = rng.random(C).astype(np.float32) * 7
    ref = run_jax_body(monkeypatch, jt, x0, betas,
                       f32_sigmas(base, betas), draws, step0, burn_in,
                       swap_every, acc0, swapacc0, bj0, cj0)

    lp0 = np.asarray(jt.log_density_td(jnp.asarray(x0)))
    state = pt_state_from_numpy(dict(
        x=x0, logp=lp0, accept_count=acc0, swap_attempt_count=0,
        swap_accept_count=swapacc0, sum_beta_sq_jump=bj0,
        sum_sq_jump_cold=cj0, step=step0), device=CPU)
    res = run_pt_fused(pt, 0, betas, base_variance=base, num_chains=C,
                       num_iterations=S, burn_in=burn_in,
                       swap_every=swap_every, resume_state=state,
                       device=CPU,
                       draws=tuple(torch.from_numpy(a) for a in draws))
    st = res.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2])
    np.testing.assert_array_equal(st.swap_accept_count.numpy(), ref[3])
    np.testing.assert_allclose(st.x.numpy(), ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_beta_sq_jump.numpy(), ref[4],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=ATOL)
    # the draws made both sides move and swap
    assert (st.accept_count.numpy() > acc0).any()
    assert (st.swap_accept_count.numpy() > swapacc0).any()
    assert st.step == step0 + S


@pytest.mark.parametrize("swap_every", [7, 1000], ids=["swaps", "no-swaps"])
def test_wrapper_bookkeeping_matches_pallas(swap_every):
    """``step`` and the analytic ``swap_attempt_count`` of a fresh run and
    of a resumed one, against run_pt_pallas in interpret mode (whose PRNG is
    degenerate on the CPU, so only its bookkeeping is compared)."""
    d, T, C = 3, 4, 8
    key = jax.random.key(0)
    betas = np.geomspace(1.0, 0.1, T).astype(np.float32)
    kw = dict(base_variance=0.5, num_chains=C, num_iterations=40,
              burn_in=10, swap_every=swap_every)
    jr = run_pt_pallas(JMVN.create(d), key, jnp.asarray(betas), **kw,
                       interpret=True)
    jr2 = run_pt_pallas(JMVN.create(d), key, jnp.asarray(betas),
                        **dict(kw, num_iterations=25),
                        resume_state=jr.state, interpret=True)
    pt = MultivariateNormal.create(d, device=CPU)
    r = run_pt_fused(pt, 0, betas, **kw, device=CPU)
    r2 = run_pt_fused(pt, 0, betas, **dict(kw, num_iterations=25),
                      resume_state=r.state, device=CPU)
    for j, p in ((jr, r), (jr2, r2)):
        assert p.state.step == int(j.state.step)
        assert p.state.swap_attempt_count == int(j.state.swap_attempt_count)
        assert tuple(p.state.x.shape) == tuple(j.state.x.shape)
        assert tuple(p.acceptance_rate.shape) == tuple(j.acceptance_rate.shape)
        assert tuple(p.swap_acceptance_rate.shape) == (C,)
    if swap_every > 65:
        assert int(r2.state.swap_accept_count.sum()) == 0


RATE_CASES = [
    ("mvn", 10, np.geomspace(1.0, 0.01, 6), 2.38 ** 2 / 10, 1024, 300, 50,
     20),
    ("rosenbrock", 30, np.geomspace(1.0, 0.01, 10), 0.5 ** 2 / 30, 256, 150,
     30, 10),
]


@pytest.mark.parametrize("case", RATE_CASES, ids=["mvn10", "rosenbrock30"])
def test_rates_match_jax_scan(case):
    """Eager (sequential sweep) and fused-plain rates against the JAX scan
    engine's sequential sweep at one config: per-rung MH acceptance and
    swap acceptance within 5 Monte-Carlo standard errors."""
    name, d, betas, var, C, iters, burn_in, swap_every = case
    betas = betas.astype(np.float32)
    if name == "mvn":
        jt, pt = JMVN.create(d), MultivariateNormal.create(d, device=CPU)
    else:
        jt, pt = JFullRosenbrock.create(d), FullRosenbrock.create(d,
                                                                  device=CPU)
    kw = dict(num_chains=C, num_iterations=iters, burn_in=burn_in,
              swap_every=swap_every)
    jr = jrun_pt(jt, JNormalProposal.create(d, var), jax.random.key(3),
                 jnp.asarray(betas), swap_sweep="sequential", **kw)
    eager = run_pt(pt, NormalProposal.create(d, var, device=CPU), 4, betas,
                   swap_sweep="sequential", device=CPU, **kw)
    fused = run_pt_fused(pt, 5, betas, base_variance=var, device=CPU, **kw)
    ja = np.asarray(jr.acceptance_rate)
    jsw = np.asarray(jr.swap_acceptance_rate)
    for label, r in (("eager", eager), ("fused", fused)):
        acc = r.acceptance_rate.numpy()
        for t in range(len(betas)):
            assert rate_z(acc[t], ja[t]) < 5, (label, t)
        assert rate_z(r.swap_acceptance_rate.numpy(), jsw) < 5, label
        assert abs(r.swap_acceptance_rate.mean().item() - jsw.mean()) < 0.05


PT_BETAS = [1.0, 0.55, 0.3, 0.16, 0.09]


@pytest.mark.parametrize("engine", ["eager-even_odd", "eager-sequential",
                                    "fused"])
def test_pt_invariance_per_rung(engine):
    """Exact invariance (tests/test_invariance.py method): replicas start
    from exact tempered draws on every rung; after 60 steps with swaps each
    rung's ensemble matches fresh exact draws at its temperature."""
    d, C = 4, 4096
    target = MultivariateNormal.create(d, device=CPU)
    g = torch.Generator().manual_seed(sum(map(ord, engine)))
    cube = torch.stack([target.direct_sample(C, b, g).T for b in PT_BETAS],
                       dim=1)
    kw = dict(num_chains=C, num_iterations=60, burn_in=0, swap_every=5,
              init_states=cube, device=CPU)
    if engine == "fused":
        r = run_pt_fused(target, 9, PT_BETAS, base_variance=1.4, **kw)
    else:
        r = run_pt(target, NormalProposal.create(d, 1.4, device=CPU), 9,
                   PT_BETAS, swap_sweep=engine.split("-")[1], **kw)
    assert float(r.swap_acceptance_rate.mean()) > 0.02
    for t, b in enumerate(PT_BETAS):
        z = invariance_max_z(r.state.x[:, t], target.direct_sample(C, b, g).T,
                             target)
        assert z < Z_MAX, (engine, t, z)


def test_fused_resume_equals_uninterrupted():
    target = FullRosenbrock.create(5, device=CPU)
    betas = np.geomspace(1.0, 0.05, 4)
    kw = dict(base_variance=0.05, num_chains=32, burn_in=6, swap_every=4,
              device=CPU)
    whole = run_pt_fused(target, 21, betas, num_iterations=45, **kw)
    a = run_pt_fused(target, 21, betas, num_iterations=20, **kw)
    b = run_pt_fused(target, 21, betas, num_iterations=25, resume_state=a.state,
                     **kw)
    for f in ("x", "logp", "accept_count", "swap_accept_count"):
        assert torch.equal(getattr(whole.state, f), getattr(b.state, f)), f
    for f in ("sum_beta_sq_jump", "sum_sq_jump_cold"):
        np.testing.assert_allclose(getattr(b.state, f).numpy(),
                                   getattr(whole.state, f).numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert b.state.step == whole.state.step == 51
    assert b.state.swap_attempt_count == whole.state.swap_attempt_count


def test_eager_resume_equals_uninterrupted():
    target = MultivariateNormal.create(3, device=CPU)
    prop = NormalProposal.create(3, 1.0, device=CPU)
    kw = dict(num_chains=16, burn_in=3, swap_every=5, device=CPU,
              swap_sweep="sequential")
    whole = run_pt(target, prop, 8, [1.0, 0.5, 0.2], num_iterations=30, **kw)
    a = run_pt(target, prop, 8, [1.0, 0.5, 0.2], num_iterations=10, **kw)
    b = run_pt(target, prop, 8, [1.0, 0.5, 0.2], num_iterations=20,
               resume_state=a.state, **kw)
    for f in ("x", "logp", "accept_count", "swap_accept_count",
              "sum_beta_sq_jump", "sum_sq_jump_cold"):
        assert torch.equal(getattr(whole.state, f), getattr(b.state, f)), f
    assert b.state.swap_attempt_count == whole.state.swap_attempt_count


def test_checkpoint_round_trip_with_jax():
    """A JAX PTState resumes on the port, and the port's state resumes on
    JAX, with cumulative counters."""
    d, T, C = 4, 3, 64
    jt = JMVN.create(d)
    betas = jnp.asarray([1.0, 0.4, 0.1], jnp.float32)
    jr = jrun_pt(jt, JNormalProposal.create(d, 1.0), jax.random.key(1), betas,
                 num_chains=C, num_iterations=30, burn_in=5, swap_every=5,
                 swap_sweep="sequential")
    fields = {f.name: np.asarray(getattr(jr.state, f.name))
              for f in dataclasses.fields(PTState)}
    st = pt_state_from_numpy(fields, device=CPU)
    assert st.step == 35 and st.x.shape == (d, T, C)
    pt = MultivariateNormal.create(d, device=CPU)
    r = run_pt_fused(pt, 2, np.asarray(betas), base_variance=1.0,
                     num_chains=C, num_iterations=20, burn_in=5,
                     swap_every=5, resume_state=st, device=CPU)
    assert r.state.step == 55
    assert (r.state.accept_count >= st.accept_count).all()
    back = JPTState(**{k: jnp.asarray(v)
                       for k, v in pt_state_to_numpy(r.state).items()})
    jr2 = jrun_pt(jt, JNormalProposal.create(d, 1.0), jax.random.key(2),
                  betas, num_chains=C, num_iterations=10, burn_in=5,
                  swap_every=5, swap_sweep="sequential", resume_state=back)
    assert int(jr2.state.step) == 65
    assert int(jr2.state.swap_attempt_count) == 12 * (T - 1)


def test_unsupported_inputs_raise():
    pt = MultivariateNormal.create(3, device=CPU)
    with pytest.raises(ValueError):
        run_pt_fused(pt, 0, [1.0, 0.5], num_chains=4, num_iterations=1,
                     device=CPU)
    full = MultivariateNormal.create(3, cov=np.diag([1.0, 2.0, 3.0]),
                                     device=CPU)
    # the kernel's target check, which runs before any launch
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _build.kernel_target(full)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _build.kernel_target(FullRosenbrock.create(65, device=CPU))


def _new_proposal(kind, d, target):
    """An anisotropic Laplace or a UniformRadius proposal of about the
    Normal cases' step size."""
    if kind == "Laplace":
        lo, hi = (0.02, 0.08) if target == "rosenbrock" else (0.8, 2.0)
        return LaplaceProposal.create(d, np.linspace(lo, hi, d), device=CPU)
    return UniformRadiusProposal.create(
        d, 0.6 if target == "rosenbrock" else 2.5, device=CPU)


# (proposal, target, d, T, C, steps, burn_in, swap_every, step0)
NEW_BODY_CASES = [
    ("Laplace", "rosenbrock", 6, 4, 16, 30, 5, 5, 0),
    ("Laplace", "mvn_iso", 5, 4, 16, 30, 10, 4, 12),
    ("UniformRadius", "rosenbrock", 6, 4, 16, 30, 3, 7, 0),
    ("UniformRadius", "mvn_iso", 5, 4, 16, 30, 10, 4, 12),
]


@pytest.mark.parametrize("case", NEW_BODY_CASES,
                         ids=["laplace-rb", "laplace-mvn-resume",
                              "uniform_radius-rb",
                              "uniform_radius-mvn-resume"])
def test_fused_plain_new_proposals_match_pallas_body(monkeypatch, case):
    """Laplace and UniformRadius: the plain version step for step against
    ``_pt_body_fn`` with the Pallas kernel's own increments (``_laplace``
    with per-rung (T, d) scales, ``_uniform_ball`` with per-rung radii) on
    shared draws, under per-rung scale multipliers.  Counts exact, floats
    to rtol 1e-5; the per-rung scales equal the reference wrapper's laws
    (pallas_pt.py:307-320) bit for bit."""
    prop, kind, d, T, C, S, burn_in, swap_every, step0 = case
    jt, pt = _jax_target(kind, d)
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    betas = np.geomspace(1.0, 0.05, T).astype(np.float32)
    mult = np.linspace(1.0, 1.5, T).astype(np.float32)
    x0 = (rng.normal(size=(d, T, C)) * 0.5).astype(np.float32)
    acc0 = rng.integers(0, 50, (T, C)).astype(np.int32)
    swapacc0 = rng.integers(0, 50, C).astype(np.int32)
    bj0 = rng.random(C).astype(np.float32) * 3
    cj0 = rng.random(C).astype(np.float32) * 7
    p = _new_proposal(prop, d, kind)
    got_kind, scales = rung_scales(p, None, torch.from_numpy(betas),
                                   torch.from_numpy(mult))
    jb, jm = jnp.asarray(betas), jnp.asarray(mult)
    if prop == "Laplace":
        want = jnp.sqrt(jnp.asarray(p.base_variance_vector.numpy())[None, :]
                        * jm[:, None] / jb[:, None] / 2.0)
    else:
        want = (jnp.asarray(p.base_radius.numpy()) * jnp.sqrt(jm)
                / jnp.sqrt(jb))
    assert got_kind == prop
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want))

    draws = make_proposal_draws(11, prop, S, T, d, C)
    ref = run_jax_body(monkeypatch, jt, x0, betas, scales.numpy(), draws,
                       step0, burn_in, swap_every, acc0, swapacc0, bj0, cj0,
                       kind=prop)
    lp0 = np.asarray(jt.log_density_td(jnp.asarray(x0)))
    state = pt_state_from_numpy(dict(
        x=x0, logp=lp0, accept_count=acc0, swap_attempt_count=0,
        swap_accept_count=swapacc0, sum_beta_sq_jump=bj0,
        sum_sq_jump_cold=cj0, step=step0), device=CPU)
    res = run_pt_fused(pt, 0, betas, proposal=p, scale_multipliers=mult,
                       num_chains=C, num_iterations=S, burn_in=burn_in,
                       swap_every=swap_every, resume_state=state, device=CPU,
                       draws=tuple(torch.from_numpy(a) for a in draws))
    st = res.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2])
    np.testing.assert_array_equal(st.swap_accept_count.numpy(), ref[3])
    np.testing.assert_allclose(st.x.numpy(), ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_beta_sq_jump.numpy(), ref[4],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()
    assert (st.swap_accept_count.numpy() > swapacc0).any()


@pytest.mark.parametrize("prop", ["Normal", "UniformRadius"])
def test_fused_plain_trace_matches_pallas_body(monkeypatch, prop):
    """Entry k of the trace is rung 0 (the cold chain) of the first
    ``record_chains`` replicas after launch-relative step (k+1) *
    record_every, taken after that step's swap sweep; the 3 trailing steps
    (23 = 4 * 5 + 3) run unrecorded.  Held against ``_pt_body_fn``'s state
    after every step (floats to rtol 1e-5), with swaps every 2 steps so
    that two of the four entries fall on swap steps."""
    d, T, C, S, every, rc = 4, 3, 8, 23, 5, 3
    jt, pt = _jax_target("mvn_iso", d)
    betas = np.geomspace(1.0, 0.7, T).astype(np.float32)
    x0 = (np.random.default_rng(4).normal(size=(d, T, C))).astype(np.float32)
    if prop == "Normal":
        p, scales = NormalProposal.create(d, 1.2, device=CPU), None
    else:
        p = UniformRadiusProposal.create(d, 2.0, device=CPU)
    _, scales = rung_scales(p, None, torch.from_numpy(betas),
                            torch.ones(T))
    draws = make_proposal_draws(5, prop, S, T, d, C)
    snaps = []
    ref = run_jax_body(monkeypatch, jt, x0, betas, scales.numpy(), draws, 0,
                       3, 2, kind=prop, snapshots=snaps)
    r = run_pt_fused(pt, 0, betas, proposal=p, num_chains=C,
                     num_iterations=S - 3, burn_in=3, swap_every=2,
                     init_states=torch.from_numpy(x0), record_every=every,
                     record_chains=rc, device=CPU,
                     draws=tuple(torch.from_numpy(a) for a in draws))
    assert tuple(r.chain.shape) == (S // every, d, rc)
    want = np.stack([snaps[(k + 1) * every - 1][:, :rc]
                     for k in range(S // every)])
    np.testing.assert_allclose(r.chain.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r.state.x.numpy(), ref[0], rtol=RTOL,
                               atol=ATOL)
    assert r.state.step == S
    assert int(r.state.swap_accept_count.sum()) > 0


def test_record_shapes_match_pallas():
    """Trace shape ``(total // record_every, d, record_chains)`` and the
    trailing steps' bookkeeping against ``run_pt_pallas(record_every=...,
    interpret=True)`` (whose PRNG is degenerate on the CPU); a
    ``record_every`` beyond the run raises on both."""
    d, T, C = 2, 3, 8
    betas = np.asarray([1.0, 0.6, 0.3], np.float32)
    kw = dict(base_variance=0.5, num_chains=C, num_iterations=25,
              burn_in=5, swap_every=4, record_every=7, record_chains=2)
    jr = run_pt_pallas(JMVN.create(d), jax.random.key(0), jnp.asarray(betas),
                       **kw, interpret=True)
    pt = MultivariateNormal.create(d, device=CPU)
    r = run_pt_fused(pt, 0, betas, **kw, device=CPU)
    e = run_pt(pt, NormalProposal.create(d, 0.5, device=CPU), 0, betas,
               **{k: v for k, v in kw.items() if k != "base_variance"},
               device=CPU)
    assert tuple(jr.chain.shape) == (30 // 7, d, 2)
    for res in (r, e):
        assert tuple(res.chain.shape) == tuple(jr.chain.shape)
        assert res.state.step == int(jr.state.step) == 30
        assert res.state.swap_attempt_count == int(
            jr.state.swap_attempt_count)
    with pytest.raises(ValueError, match="record_every"):
        run_pt_pallas(JMVN.create(d), jax.random.key(0), jnp.asarray(betas),
                      **dict(kw, record_every=31), interpret=True)
    with pytest.raises(ValueError, match="record_every"):
        run_pt_fused(pt, 0, betas, **dict(kw, record_every=31), device=CPU)


def _trace_z(a, b, burn):
    """Max z over the coordinates' first and second moments of two traces
    ``(n_rec, d, C)``: per-chain averages over the post-burn-in entries,
    chains independent."""
    zs = []
    for f in (lambda x: x, np.square):
        ma = f(np.asarray(a, np.float64)[burn:]).mean(0)   # (d, C)
        mb = f(np.asarray(b, np.float64)[burn:]).mean(0)
        for i in range(ma.shape[0]):
            zs.append(rate_z(ma[i], mb[i]))
    return max(zs)


def test_trace_moments_match_jax_scan():
    """The cold-chain traces of the fused plain version and of the eager
    engine against the JAX scan engine's on MVN d=2, T=3: the coordinates'
    first and second moments within 5 Monte-Carlo standard errors."""
    d, T, C = 2, 3, 256
    betas = np.asarray([1.0, 0.5, 0.25], np.float32)
    kw = dict(num_chains=C, num_iterations=240, burn_in=60, swap_every=5,
              record_every=4, record_chains=C)
    jr = jrun_pt(JMVN.create(d), JNormalProposal.create(d, 2.0),
                 jax.random.key(6), jnp.asarray(betas),
                 swap_sweep="sequential", **kw)
    pt = MultivariateNormal.create(d, device=CPU)
    fused = run_pt_fused(pt, 7, betas, base_variance=2.0, device=CPU, **kw)
    eager = run_pt(pt, NormalProposal.create(d, 2.0, device=CPU), 8, betas,
                   swap_sweep="sequential", device=CPU, **kw)
    ref = np.asarray(jr.chain)
    for label, r in (("fused", fused), ("eager", eager)):
        assert tuple(r.chain.shape) == ref.shape == (75, d, C)
        assert _trace_z(r.chain.numpy(), ref, 15) < 5, label
