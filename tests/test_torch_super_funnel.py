"""SuperFunnel in the port against the JAX package, on the same numpy
inputs: JAX's threefry streams (``split``, ``normal``, ``bernoulli``,
``erf_inv``) bit for bit, the synthetic dataset, the log-density with its
-inf where a tau is at most 1e-9, ``convert`` both ways, the plain fused
PT and RWM versions step for step against the Pallas body from the
default init's -inf starts, the eager engines' rates against the JAX scan
engine, the harness, the study CLI, and the kernel's parameter layout and
shared-memory geometry (kind 12, ``csrc/targets.cuh``)."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_port_helpers import f32_sigmas, make_draws, rate_z, run_jax_body
from rwm_pt_tpu.api import MCMCSimulation as JSim
from rwm_pt_tpu.cli import experiment_rwm as jcli
from rwm_pt_tpu.cli.common import resolve_actual_dim as jdim
from rwm_pt_tpu.kernels import run_pt as jrun_pt
from rwm_pt_tpu.kernels import run_rwm as jrun_rwm
from rwm_pt_tpu.proposals import NormalProposal as JNormalProposal
from rwm_pt_tpu.targets import SuperFunnel as JSuperFunnel
from rwm_pt_tpu.targets import calculate_super_funnel_dim as jsf_dim
from rwm_pt_tpu_torch.api import MCMCSimulation as TSim
from rwm_pt_tpu_torch.cli import experiment_rwm as tcli
from rwm_pt_tpu_torch.cli.common import resolve_actual_dim as tdim
from rwm_pt_tpu_torch.convert import (pt_state_from_numpy,
                                      rwm_state_from_numpy,
                                      target_from_numpy, target_to_numpy)
from rwm_pt_tpu_torch.kernels import (_build, run_pt, run_pt_fused, run_rwm,
                                      run_rwm_fused)
from rwm_pt_tpu_torch.proposals import NormalProposal
from rwm_pt_tpu_torch.targets import (SuperFunnel, calculate_super_funnel_dim,
                                      get_target_distribution)
from rwm_pt_tpu_torch.utils import threefry

torch.set_num_threads(1)
CPU = "cpu"
RTOL = 1e-5       # the port's f32 log-density against JAX's (sum orders)
CONFIGS = [(5, 3, 20, 42), (3, 2, 10, 0), (10, 5, 20, 7), (40, 3, 20, 1)]
SMALL = (3, 2, 10, 0)     # J, K, n, seed of the step-for-step holds


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32)).max(initial=0))


def _pair(J, K, n, seed):
    return (JSuperFunnel.create_synthetic(J, K, n, seed=seed),
            SuperFunnel.create_synthetic(J, K, n, seed=seed, device=CPU))


def _states(jt, batch, seed):
    """Valid states (taus in [0.1, 2.1)) with some taus set at or below
    1e-9 (at it, 0, negative) in the first rows of the last batch axis."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(jt.dim,) + batch).astype(np.float32)
    x[-2:] = np.abs(x[-2:]) * 2 + np.float32(0.1)
    flat = x.reshape(jt.dim, -1)
    flat[-1, 0], flat[-2, 1], flat[-2, 2] = 1e-9, 0.0, -1.0
    flat[-1, 3], flat[-2, 3] = -1e-3, 1e-9
    flat[-1, 4] = np.float32(1.0000001e-9)          # just above: valid
    return x


# ---------------------------------------------------------------- threefry
@pytest.mark.parametrize("seed", [0, 1, 42, 7, 123456789])
def test_threefry_split_normal_bernoulli_match_jax(seed):
    """``split``, ``uniform``, ``normal`` and ``bernoulli`` bit for bit
    against ``jax.random`` at several shapes."""
    keys = jax.random.split(jax.random.key(seed))
    ours = threefry.split(seed)
    assert ours == [tuple(int(v) for v in jax.random.key_data(k))
                    for k in keys]
    assert threefry.split(seed, 3) == [
        tuple(int(v) for v in jax.random.key_data(k))
        for k in jax.random.split(jax.random.key(seed), 3)]
    rng = np.random.default_rng(seed)
    for shape in [(5, 20, 3), (7,), (3, 4), (40, 20, 3)]:
        for ko, kj in zip(ours, keys):
            np.testing.assert_array_equal(
                threefry.uniform(ko, shape),
                np.asarray(jax.random.uniform(kj, shape)))
            n_ours = threefry.normal(ko, shape)
            n_jax = np.asarray(jax.random.normal(kj, shape))
            assert n_ours.dtype == np.float32
            assert _ulps(n_ours, n_jax) == 0
            p = rng.random(shape, dtype=np.float32)
            np.testing.assert_array_equal(
                threefry.bernoulli(ko, p),
                np.asarray(jax.random.bernoulli(kj, p)))


def test_erf_inv_matches_lax_on_a_dense_grid():
    """``erf_inv`` bit for bit against ``lax.erf_inv`` on a dense grid of
    (-1, 1), on both sides of w = 5 and of log1p's |x| = sqrt(2) - 1
    switch, and on the uniforms ``normal`` feeds it."""
    one = np.float32(1.0)
    grid = np.concatenate([
        np.linspace(-0.99999994, 0.99999994, 1 << 20, dtype=np.float32),
        np.nextafter(one, np.float32(0)) - np.arange(4096, dtype=np.float32)
        * np.float32(2 ** -24),
        np.float32([0.0, -0.0, 2 ** -24, -(2 ** -24), 0.6435942, 0.9966]),
        threefry.uniform(3, 1 << 16, np.nextafter(-one, np.float32(0)), 1.0),
    ]).astype(np.float32)
    assert _ulps(threefry.erf_inv(grid),
                 np.asarray(jax.jit(lax.erf_inv)(grid))) == 0
    with pytest.raises(ValueError):
        threefry.erf_inv(np.float32([1.0]))


# ---------------------------------------------------------------- the target
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "J{}K{}n{}s{}".format(*c))
def test_create_synthetic_matches_jax(cfg):
    """The dataset of one seed: X_cols bit for bit (0 ulps, enforced), Y
    exactly, the JAX dim and name."""
    jt, pt = _pair(*cfg)
    J, K, n, _ = cfg
    assert pt.dim == jt.dim == calculate_super_funnel_dim(J, K) == \
        jsf_dim(J, K)
    assert (pt.J, pt.K, pt.get_name()) == (jt.J, jt.K, jt.get_name())
    assert tuple(pt.X_cols.shape) == (J * K, n) and pt.X_cols.dtype == \
        torch.float32
    assert _ulps(pt.X_cols.numpy(), np.asarray(jt.X_cols)) == 0
    np.testing.assert_array_equal(pt.Y.numpy(), np.asarray(jt.Y))
    for f in ("prior_hypermean_std", "prior_tau_scale"):
        assert float(getattr(pt, f)) == float(getattr(jt, f))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "J{}K{}n{}s{}".format(*c))
def test_log_density_matches_jax(cfg):
    """rtol 1e-5 on valid states, -inf in the same places where a tau is
    at or below 1e-9; both layouts."""
    jt, pt = _pair(*cfg)
    x = _states(jt, (3, 40), cfg[3])
    ref = np.asarray(jt.log_density_td(jnp.asarray(x)))
    ours = pt.log_density_td(torch.from_numpy(x)).numpy()
    fin = np.isfinite(ref)
    assert not fin.all() and fin.mean() > 0.9
    np.testing.assert_array_equal(np.isfinite(ours), fin)
    assert (ours[~fin] == -np.inf).all() and (ref[~fin] == -np.inf).all()
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=RTOL)
    xb = np.moveaxis(x[:, 0], 0, -1)                        # (C, d)
    np.testing.assert_allclose(pt.log_density(torch.from_numpy(xb)).numpy(),
                               np.asarray(jt.log_density(jnp.asarray(xb))),
                               rtol=RTOL)
    one = pt.log_density(torch.from_numpy(xb[5]))
    assert one.shape == () and np.isclose(float(one), ours[0, 5], rtol=RTOL)


def test_create_checks_shapes_and_has_no_direct_sampler():
    X = np.zeros((2, 4, 3), np.float32)
    with pytest.raises(ValueError, match="X_data"):
        SuperFunnel.create(2, 2, X, np.zeros((2, 4)), device=CPU)
    with pytest.raises(ValueError, match="Y_data"):
        SuperFunnel.create(2, 3, X, np.zeros((2, 5)), device=CPU)
    t = SuperFunnel.create(2, 3, X, np.ones((2, 4)), device=CPU)
    assert t.dim == 2 + 6 + 1 + 3 + 2
    with pytest.raises(NotImplementedError, match="direct sampler"):
        t.direct_sample(4)
    init = t.init_sample(8, torch.Generator().manual_seed(0))
    assert init.shape == (8, t.dim) and init.abs().max() < 1e-6


def test_convert_both_ways():
    """JAX's exact arrays build the port's target (dim from J and K when
    left out), and the port's fields rebuild the JAX target."""
    jt, pt = _pair(*SMALL)
    fields = {k: np.asarray(getattr(jt, k)) if k not in ("J", "K", "dim")
              else getattr(jt, k)
              for k in ("dim", "J", "K", "X_cols", "Y",
                        "prior_hypermean_std", "prior_tau_scale")}
    back = target_from_numpy("SuperFunnel", fields, device=CPU)
    del fields["dim"]
    assert target_from_numpy("SuperFunnel", fields, device=CPU).dim == jt.dim
    out = target_to_numpy(pt)
    assert set(out) == {"dim", "J", "K", "X_cols", "Y", "name",
                        "prior_hypermean_std", "prior_tau_scale"}
    jback = JSuperFunnel(**{k: (v if k in ("dim", "J", "K", "name")
                               else jnp.asarray(v)) for k, v in out.items()})
    x = _states(jt, (30,), 5)
    ref = np.asarray(jt.log_density_td(jnp.asarray(x)))
    np.testing.assert_array_equal(
        back.log_density_td(torch.from_numpy(x)).numpy(),
        pt.log_density_td(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jback.log_density_td(jnp.asarray(x))), ref)


# ------------------------------------------------- plain fused, step by step
def _default_starts(pt, batch, seed):
    """The default init, 1e-8 N(0, 1): most states start at -inf."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(batch))
    x = pt.init_sample(n, g).T.reshape((pt.dim,) + batch)
    return x.numpy().copy()


def test_fused_pt_plain_matches_pallas_body(monkeypatch):
    """The plain fused PT version step for step against the Pallas body
    ``_pt_body_fn`` on injected draws, from the default init's -inf starts:
    counters exactly, floats to rtol 1e-5, -inf in the same places."""
    jt, pt = _pair(*SMALL)
    d, T, C, S = jt.dim, 3, 24, 16
    betas = np.asarray([1.0, 0.5, 0.25], np.float32)
    var = 0.05
    x0 = _default_starts(pt, (T, C), 3)
    lp0 = np.asarray(jt.log_density_td(jnp.asarray(x0)))
    assert 0.5 < np.isinf(lp0).mean() < 1.0
    draws = make_draws(11, S, T, d, C)
    ref = run_jax_body(monkeypatch, jt, x0, betas, f32_sigmas(var, betas),
                       draws, 0, 4, 3)
    z = np.zeros(C, np.float32)
    state = pt_state_from_numpy(dict(
        x=x0, logp=lp0, accept_count=np.zeros((T, C), np.int32),
        swap_attempt_count=0, swap_accept_count=np.zeros(C, np.int32),
        sum_beta_sq_jump=z, sum_sq_jump_cold=z, step=0), device=CPU)
    res = run_pt_fused(pt, 0, betas, base_variance=var, num_chains=C,
                       num_iterations=S, burn_in=4, swap_every=3,
                       resume_state=state, device=CPU,
                       draws=tuple(torch.from_numpy(a) for a in draws))
    st = res.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2])
    np.testing.assert_array_equal(st.swap_accept_count.numpy(), ref[3])
    np.testing.assert_allclose(st.x.numpy(), ref[0], rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(np.isfinite(st.logp.numpy()),
                                  np.isfinite(ref[1]))
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL)
    np.testing.assert_allclose(st.sum_beta_sq_jump.numpy(), ref[4],
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=1e-6)
    assert (st.accept_count.numpy() > 0).any()
    assert (st.swap_accept_count.numpy() > 0).any()


def test_fused_rwm_plain_matches_pallas_body(monkeypatch):
    """The plain fused RWM version against the Pallas body at T = 1 with
    no swaps, from the default init's -inf starts."""
    jt, pt = _pair(*SMALL)
    d, C, S = jt.dim, 32, 16
    x0 = _default_starts(pt, (C,), 4)
    lp0 = np.asarray(jt.log_density_td(jnp.asarray(x0)))
    assert np.isinf(lp0).any()
    normals, u_mh, _ = make_draws(17, S, 1, d, C)
    betas = np.ones(1, np.float32)
    ref = run_jax_body(monkeypatch, jt, x0[:, None], betas,
                       f32_sigmas(0.05, betas), (normals, u_mh, u_mh[:, :0]),
                       0, 5, 10 ** 6)
    state = rwm_state_from_numpy(dict(
        x=x0, logp=lp0, accept_count=np.zeros(C, np.int32),
        sum_sq_jump=np.zeros(C, np.float32), step=0), device=CPU)
    r = run_rwm_fused(pt, 0, base_variance=0.05, num_chains=C,
                      num_iterations=S, burn_in=5, resume_state=state,
                      device=CPU, draws=(torch.from_numpy(normals[:, 0]),
                                         torch.from_numpy(u_mh[:, 0])))
    st = r.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2][0])
    np.testing.assert_allclose(st.x.numpy(), ref[0][:, 0], rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(st.logp.numpy(), ref[1][0], rtol=RTOL)
    np.testing.assert_allclose(st.sum_sq_jump.numpy(), ref[5], rtol=RTOL,
                               atol=1e-6)


# ------------------------------------------------------------ rates, harness
def test_eager_rates_match_jax_scan():
    """The eager RWM and PT engines' acceptance (per rung) and swap
    acceptance against the JAX scan engine's at the reference's dataset:
    within 5 Monte-Carlo standard errors."""
    jt = JSuperFunnel.create_synthetic()
    pt = SuperFunnel.create_synthetic(device=CPU)
    d, var = jt.dim, 0.05
    kw = dict(num_chains=512, num_iterations=200, burn_in=100)
    jr = jrun_rwm(jt, JNormalProposal.create(d, var), jax.random.key(1), **kw)
    r = run_rwm(pt, NormalProposal.create(d, var, device=CPU), 2,
                device=CPU, **kw)
    assert rate_z(r.acceptance_rate.numpy(),
                  np.asarray(jr.acceptance_rate)) < 5
    betas = np.asarray([1.0, 0.6, 0.35], np.float32)
    kw = dict(num_chains=256, num_iterations=150, burn_in=100, swap_every=5)
    jp = jrun_pt(jt, JNormalProposal.create(d, var), jax.random.key(3),
                 jnp.asarray(betas), swap_sweep="sequential", **kw)
    p = run_pt(pt, NormalProposal.create(d, var, device=CPU), 4, betas,
               swap_sweep="sequential", device=CPU, **kw)
    ja, acc = np.asarray(jp.acceptance_rate), p.acceptance_rate.numpy()
    for t in range(len(betas)):
        assert rate_z(acc[t], ja[t]) < 5, t
    assert rate_z(p.swap_acceptance_rate.numpy(),
                  np.asarray(jp.swap_acceptance_rate)) < 5


def test_simulation_takes_dim_from_the_target():
    """``dim=None`` takes the target's dim (26 at J = 5, K = 3), as JAX's
    harness does (tests/test_rwm_correctness.py::
    test_dim_derived_from_structured_target); the fused engine runs it."""
    kw = dict(dim=None, sigma=0.1, num_iterations=40, algorithm="RWM",
              target_dist="SuperFunnel", num_chains=8, burn_in=20,
              record_chain=False, seed=2,
              target_kwargs={"J": 5, "K": 3, "n_per_group": 20})
    sim = TSim(device=CPU, **kw)
    assert sim.dim == JSim(**kw).dim == 26
    sim.generate_samples(verbose=False)
    assert sim.engine_used == "pallas"
    assert 0.0 <= float(np.mean(sim.acceptance_rate())) <= 1.0
    pt = TSim(dim=None, sigma=0.01, num_iterations=20, algorithm="PT",
              target_dist="SuperFunnel", num_chains=4, burn_in=10,
              beta_ladder=[1.0, 0.5], swap_every=5, record_chain=False,
              device=CPU)
    pt.generate_samples(verbose=False)
    assert pt.dim == 26 and pt.engine_used == "pallas"


def test_iterative_ladder_refuses_as_jax_does():
    """No direct sampler, so no iterative ladder: the JAX message."""
    kw = dict(dim=None, sigma=0.1, num_iterations=10, algorithm="PT",
              iterative_temp_spacing=True, target_dist="SuperFunnel",
              num_chains=8)
    with pytest.raises(NotImplementedError) as je:
        JSim(**kw)
    with pytest.raises(NotImplementedError, match="direct_sample") as te:
        TSim(device=CPU, **kw)
    assert "iterative temperature ladder" in str(je.value)
    assert "iterative temperature ladder" in str(te.value)


def test_cli_dim_and_study_json_keys(tmp_path):
    """``resolve_actual_dim`` as JAX's, and ``experiment_rwm --target
    SuperFunnel --cpu`` writes the JAX study's JSON keys."""
    args = types.SimpleNamespace(target="SuperFunnel", dim=7,
                                 super_funnel_J=4, super_funnel_K=2)
    assert tdim(args) == jdim(args) == 4 + 8 + 1 + 2 + 2
    argv = ["--target", "SuperFunnel", "--num_iters", "30", "--burn_in",
            "10", "--num_configs", "2", "--num_chains", "8", "--var_max",
            "1.0", "--seed", "4", "--no_plots", "--proposal", "Normal",
            "--cpu"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcli.main(argv + ["--output_dir", str(jdir)])
    tcli.main(argv + ["--output_dir", str(tdir)])
    (jfile,), (tfile,) = os.listdir(jdir), os.listdir(tdir)
    assert tfile.startswith("SuperFunnel_Normal_") and "dim26" in tfile
    with open(jdir / jfile) as f:
        jdata = json.load(f)
    with open(tdir / tfile) as f:
        tdata = json.load(f)
    assert set(tdata) == set(jdata)


# ---------------------------------------------------- the kernel's layout
def test_kernel_target_layout():
    """Kind 12's parameter vector (``csrc/targets.cuh``): J, K, n, the
    float32 constants as the plain version rounds them, X_cols, Y."""
    pt = get_target_distribution("SuperFunnel", 0, J=4, K=2, n_per_group=6,
                                 prior_hypermean_std=3.0,
                                 prior_tau_scale=1.5, device=CPU)
    kind, p = _build.kernel_target(pt)
    assert kind == "super_funnel" and _build.TARGET_KINDS[kind] == 12
    assert _build.target_kind(pt) == kind
    J, K, n, head = 4, 2, 6, 10
    assert p.dtype == torch.float32 and p.numel() == head + J * K * n + J * n
    f = np.float32
    l2p = np.log(2 * np.pi)
    hv = f(3.0) * f(3.0)
    np.testing.assert_array_equal(p[:3].numpy(), [4, 2, 6])
    np.testing.assert_array_equal(p[3:head].numpy(), np.array([
        f(-0.5 * J * l2p), f(-0.5 * J * K * l2p), hv,
        f(f(-0.5 * l2p) - f(f(0.5) * np.log(hv))),
        f(f(-0.5 * K * l2p) - f(f(0.5 * K) * np.log(hv))),
        f(f(np.log(2.0) - np.log(np.pi)) - np.log(f(1.5))), f(1.5)],
        np.float32))
    np.testing.assert_array_equal(p[head:head + J * K * n].numpy(),
                                  pt.X_cols.numpy().ravel())
    np.testing.assert_array_equal(p[head + J * K * n:].numpy(),
                                  pt.Y.numpy().ravel())
    # the team kernels above 64 dimensions take it too
    wide = get_target_distribution("SuperFunnel", 0, J=10, K=5, device=CPU)
    assert wide.dim == 68 and _build.lib_name(
        "fused_pt_lax_erfinv", "super_funnel", wide.dim).endswith(".w128")
    assert _build.lib_name("fused_rwm", "super_funnel", 166).endswith(
        ".w256")


def test_geometry_counts_the_stage_row_and_refuses_oversized_data():
    """The thread kernels' stage row (DMAX + 1 words a thread) is counted
    for kind 12 only; a dataset that no block holds is refused with a
    message that names its words, at d = 26 (bucket 32)."""
    assert _build.row_words(32, kind="super_funnel") == \
        _build.row_words(32) + 33
    assert _build.row_words(32, kind="rosenbrock") == _build.row_words(32)
    small = 10 + 15 * 20 + 5 * 20
    g = _build.pt_block_geometry(96, 320, 26, 32, 8, 65536, "Normal",
                                 "lax_erfinv", small, "super_funnel")
    assert g.shared_bytes == _build.pt_shared_bytes(
        small, 8, 26, g.replicas, 32, "Normal", "lax_erfinv",
        "super_funnel") > _build.pt_shared_bytes(
        small, 8, 26, g.replicas, 32, "Normal", "lax_erfinv")
    r = _build.rwm_block_geometry(80, 128, 26, 32, 65536, "Normal",
                                  "lax_erfinv", small, "super_funnel")
    assert r.replicas == 128 and r.shared_bytes == 4 * (
        128 * (36 + 33) + small)
    big = 10 + 15 * 4000 + 5 * 4000
    with pytest.raises(ValueError, match=f"{big} of its words"):
        _build.pt_block_geometry(96, 320, 26, 32, 8, 65536, "Normal",
                                 "lax_erfinv", big, "super_funnel")
    with pytest.raises(ValueError, match=f"{big} of its words"):
        _build.rwm_block_geometry(80, 128, 26, 32, 65536, "Normal",
                                  "lax_erfinv", big, "super_funnel")
    # the team kernels read parameters beyond the shared cap through L2
    assert _build.params_shared_words(big) == 0
    assert _build.pt_warp_shared_bytes(big, 8, 166, 1, 256, team=8,
                                       kind="super_funnel") < \
        _build.BLOCK_SHARED


# ------------------------------------ the build with the dataset's shape fixed
FITS = [(2, 1, 20), (3, 2, 20), (5, 3, 20), (10, 3, 20)]


@pytest.mark.parametrize("algo", ["pt", "rwm"])
@pytest.mark.parametrize("shape", FITS, ids=lambda s: "J{}K{}n{}".format(*s))
def test_route_takes_the_fixed_shape_where_the_dataset_fits(shape, algo):
    """A dataset whose packed words fit the kernel's parameters takes the
    library of its shape, ``<variant>.super_funnel.j<J>k<K>n<n>u<u>b<b>.
    d<D>``, built with the shape's defines, its source's unroll and
    ``SF_MIN_BLOCKS`` (not ``FEWER_BLOCKS``: it stages nothing), both in
    its name, launched under its own key, its dataset packed on the host;
    ``specialize=False`` forces the run-time library, which keeps
    ``FEWER_BLOCKS``."""
    J, K, n = shape
    pt = get_target_distribution("SuperFunnel", 0, J=J, K=K, n_per_group=n,
                                 device=CPU)
    variant = _build.library(f"fused_{algo}", "Normal", "lax_erfinv")
    lib, kind, words = _build.route(variant, pt)
    dmax = _build.bucket(pt.dim)
    unroll = min(_build.SF_UNROLL[f"fused_{algo}"], n)
    blocks = _build.SF_MIN_BLOCKS[f"fused_{algo}"] if dmax <= 32 else 1
    tag = f"j{J}k{K}n{n}u{unroll}b{blocks}"
    assert kind == "super_funnel"
    assert lib == f"{variant}.super_funnel.{tag}.d{dmax}"
    assert _build.launch_key(lib) == f"{variant}.super_funnel.{tag}"
    assert _build.by_variant({_build.launch_key(lib): 2}) == {
        f"{variant}.{tag}": 2}
    flags = _build._flags(lib)
    for define, v in (("J", J), ("K", K), ("N", n), ("UNROLL", unroll)):
        assert f"-DRWM_PT_SF_{define}={v}" in flags
    assert f"-DRWM_PT_MINBLOCKS={blocks}" in flags
    assert words.device.type == "cpu" and words.dtype == torch.float32
    assert words.numel() == _build.sf_words(J, K, n) <= \
        _build.SF_FIXED_MAX_WORDS
    assert _build.fixed_shape(lib) == dict(J=J, K=K, n=n, dim=pt.dim,
                                           unroll=unroll, blocks=blocks)
    run_time, _, params = _build.route(variant, pt, specialize=False)
    assert run_time == f"{variant}.super_funnel.d{dmax}"
    assert _build.fixed_shape(run_time) is None
    assert "-DRWM_PT_SF_J" not in " ".join(_build._flags(run_time))
    assert _build._lib_path(lib) != _build._lib_path(run_time)
    assert torch.equal(params, _build.kernel_target(pt)[1])


@pytest.mark.parametrize("J,K,n", [(5, 3, 4000), (5, 3, 45), (10, 5, 210),
                                   (40, 3, 80)])
def test_route_takes_the_run_time_library_elsewhere(J, K, n):
    """A dataset over the parameters' words (n_per_group = 4000, and 45 at
    the reference's J and K: 910 words), and a d > 64 dataset whose padded
    words exceed the team kernels' shared-memory budget (12,632 and 12,972
    of PARAMS_SHARED_MAX's 12,288), take the run-time-shape library,
    whether or not ``specialize=False`` forces it; warp=True takes the
    team kernel at any d, and no fixed-shape name exists there below 65."""
    pt = get_target_distribution("SuperFunnel", 0, J=J, K=K, n_per_group=n,
                                 device=CPU)
    for algo in ("pt", "rwm"):
        variant = _build.library(f"fused_{algo}", "Normal", "lax_erfinv")
        lib, _, params = _build.route(variant, pt)
        assert lib == _build.lib_name(variant, "super_funnel", pt.dim)
        assert _build.fixed_shape(lib) is None
        assert torch.equal(params, _build.kernel_target(pt)[1])
        if pt.dim <= 64:
            assert lib.endswith(f".d{_build.bucket(pt.dim)}")
            assert _build.sf_words(J, K, n) > _build.SF_FIXED_MAX_WORDS
        else:
            assert lib.endswith(f".w{_build.warp_bucket(pt.dim)}")
            assert _build.sf_team_words(J, K, n) > _build.PARAMS_SHARED_MAX
        assert _build.route(variant, pt, specialize=False)[0] == lib
    ref = get_target_distribution("SuperFunnel", 0, device=CPU)
    assert _build.route("fused_pt", ref, warp=True)[0] == \
        "fused_pt.super_funnel.w128"
    with pytest.raises(ValueError, match="no fixed-shape library"):
        _build.lib_name("fused_pt", "super_funnel", ref.dim, warp=True,
                        sf=_build.sf_tag(5, 3, 20, "fused_pt"))


TEAM_SHAPES = [(10, 5, 20), (40, 3, 20)]     # d = 68 (.w128), 166 (.w256)


@pytest.mark.parametrize("J,K,n", TEAM_SHAPES)
def test_route_takes_the_fixed_team_build_above_64_dimensions(J, K, n):
    """Above 64 dimensions a dataset whose padded words fit the team
    kernels' shared memory takes the team build of its shape,
    ``<variant>.super_funnel.j<J>k<K>n<n>u<u>.w<D>``: the shape's
    defines, the team sizes of its bucket, the team source's ``SF_UNROLL``
    in its name and flags (no blocks: the team kernels' launch bound is
    fixed in their source), launched under its whole
    name, its dataset padded by ``sf_team_pack`` (to go to the card);
    ``specialize=False`` forces the run-time team library, and ``warp=
    False`` has no library there."""
    pt = get_target_distribution("SuperFunnel", 0, J=J, K=K, n_per_group=n,
                                 device=CPU)
    dmax = _build.warp_bucket(pt.dim)
    for algo in ("pt", "rwm"):
        src = f"fused_{algo}"
        variant = _build.library(src, "Normal", "lax_erfinv")
        lib, kind, words = _build.route(variant, pt)
        unroll = min(_build.SF_UNROLL[src + _build.WARP], n)
        tag = f"j{J}k{K}n{n}u{unroll}"
        assert kind == "super_funnel"
        assert lib == f"{variant}.super_funnel.{tag}.w{dmax}"
        assert _build.is_warp(lib) and _build.launch_key(lib) == lib
        assert _build.by_variant({lib: 3}) == {f"{variant}.{tag}": 3}
        assert _build.fixed_shape(lib) == dict(J=J, K=K, n=n, dim=pt.dim,
                                               unroll=unroll, blocks=None)
        assert _build._parts(lib) == (src + _build.WARP, 0, 3, 12, dmax, 1)
        assert _build.library_teams(lib) == _build.WARP_TEAMS[dmax]
        assert {f"-DRWM_PT_SF_J={J}", f"-DRWM_PT_SF_K={K}",
                f"-DRWM_PT_SF_N={n}", f"-DRWM_PT_SF_UNROLL={unroll}",
                "-DRWM_PT_MINBLOCKS=1", f"-DRWM_PT_DMAX={dmax}",
                f"-DRWM_PT_TEAMS={sum(_build.WARP_TEAMS[dmax])}"} <= set(
                    _build._flags(lib))
        assert words.device.type == "cpu" and words.dtype == torch.float32
        assert torch.equal(words, _build.sf_team_pack(
            _build.kernel_target(pt)[1]))
        assert words.numel() == _build.sf_team_words(J, K, n) <= \
            _build.PARAMS_SHARED_MAX
        assert _build.sf_shape("super_funnel", pt.dim,
                               _build.kernel_target(pt)[1]) == (J, K, n)
        assert _build.sf_shape("super_funnel", pt.dim,
                               _build.kernel_target(pt)[1], warp=True) == \
            (J, K, n)
        run_time, _, params = _build.route(variant, pt, specialize=False)
        assert run_time == f"{variant}.super_funnel.w{dmax}"
        assert torch.equal(params, _build.kernel_target(pt)[1])
        assert "-DRWM_PT_SF_J" not in " ".join(_build._flags(run_time))
        assert _build._lib_path(lib) != _build._lib_path(run_time)
        with pytest.raises(NotImplementedError):
            _build.route(variant, pt, warp=False)


def test_forced_fixed_shape_builds_and_tags(monkeypatch):
    """A fixed-shape build's observation unroll and blocks an SM come from
    ``SF_UNROLL`` and ``SF_MIN_BLOCKS`` into its name and its flags, so a
    comparison that sets them gets builds of their own; the d > 32 buckets
    hold one block, and a team build's name carries no blocks; bad tags
    are refused."""
    pt = get_target_distribution("SuperFunnel", 0, device=CPU)
    assert _build.route("fused_pt_lax_erfinv", pt)[0] == \
        "fused_pt_lax_erfinv.super_funnel.j5k3n20u2b3.d32"
    monkeypatch.setitem(_build.SF_UNROLL, "fused_pt", 4)
    monkeypatch.setitem(_build.SF_MIN_BLOCKS, "fused_pt", 2)
    lib = _build.route("fused_pt_lax_erfinv", pt)[0]
    assert lib == "fused_pt_lax_erfinv.super_funnel.j5k3n20u4b2.d32"
    assert _build._parts(lib)[4:] == (32, 2)
    assert {"-DRWM_PT_SF_UNROLL=4", "-DRWM_PT_MINBLOCKS=2"} <= set(
        _build._flags(lib))
    monkeypatch.setitem(_build.SF_UNROLL, "fused_pt", 25)
    assert _build.sf_tag(5, 3, 20, "fused_pt") == "j5k3n20u20b2"
    assert _build.sf_tag(10, 3, 20, "fused_pt") == "j10k3n20u20b1"   # d46
    with pytest.raises(ValueError):
        _build.lib_name("fused_pt", "rosenbrock", 26, sf="j5k3n20u2b3")
    with pytest.raises(ValueError):
        _build.lib_name("fused_pt", "super_funnel", 27, sf="j5k3n20u2b3")
    with pytest.raises(ValueError):
        _build.lib_name("fused_pt", "super_funnel", 26, sf="j5k3n20")
    # a fixed name takes the layout and the bucket of its d: d = 26 has no
    # team build, d = 68 no thread build and no .w256 one; a thread name
    # carries its blocks, a team name none
    with pytest.raises(ValueError):
        _build._parts("fused_pt.super_funnel.j5k3n20u2b3.w128")
    with pytest.raises(ValueError):
        _build._parts("fused_pt.super_funnel.j5k3n20u2.d32")
    for bad in ("d64", "w256", "d128"):
        with pytest.raises(ValueError):
            _build._parts(f"fused_pt.super_funnel.j10k5n20u2.{bad}")
    with pytest.raises(ValueError):
        _build._parts("fused_pt.super_funnel.j10k5n20u2b2.w128")
    assert _build._parts("fused_pt.super_funnel.j10k5n20u4.w128") == (
        "fused_pt_warp", 0, 0, 12, 128, 1)
    monkeypatch.setitem(_build.SF_UNROLL, "fused_pt_warp", 5)
    assert _build.sf_tag(10, 5, 20, "fused_pt") == "j10k5n20u5"   # d68
    wide = get_target_distribution("SuperFunnel", 0, J=10, K=5, device=CPU)
    lib = _build.route("fused_pt_lax_erfinv", wide)[0]
    assert lib == "fused_pt_lax_erfinv.super_funnel.j10k5n20u5.w128"
    assert {"-DRWM_PT_SF_UNROLL=5", "-DRWM_PT_MINBLOCKS=1"} <= set(
        _build._flags(lib))
    assert _build.lib_name("fused_pt_lax_erfinv", "super_funnel", 68,
                           sf="j10k5n20u5") == lib
    with pytest.raises(ValueError, match="no fixed-shape library"):
        _build.lib_name("fused_pt", "super_funnel", 68, warp=False,
                        sf="j10k5n20u5")
    assert _build.fixed_shape("fused_pt.super_funnel.d32") is None
    assert _build.fixed_shape("fused_pt.mvn_iso.w128") is None


def _signed_group(obs, alpha, betas, K):
    """A group's likelihood from its observations' packed words ``obs``
    ((n, K + 1): X'_0 .. X'_{K-1}, sigma) as the fixed-shape builds compute
    it: eta' = sigma alpha + X'_0 beta_0 (sigma alpha exact, so one
    rounding, as the FFMA) + X'_k beta_k .., each term -(max(eta', 0) +
    log1p(exp(-|eta'|))), summed in order."""
    s = torch.zeros_like(alpha)
    for w in obs:
        eta = w[K] * alpha + w[0] * betas[0]
        for k in range(1, K):
            eta = eta + w[k] * betas[k]
        s = s + -(torch.clamp_min(eta, 0.0)
                  + torch.log1p(torch.exp(-eta.abs())))
    return s


def _fixed_log_density(words, x, J, K, n):
    """The fixed-shape thread build's arithmetic (``csrc/targets.cuh::
    super_funnel_log_density_fixed``) in f32 on the CPU, from the packed
    words: each group by :func:`_signed_group`, the sums in order, then
    the closing formula."""
    obs = words[_build.SF_HEAD:].reshape(J, n, K + 1)
    d = J + J * K + K + 3
    x = x.reshape(d, -1)
    ll = torch.zeros_like(x[0])
    for j in range(J):
        ll = ll + _signed_group(obs[j], x[j], x[J + j * K:J + j * K + K], K)
    return _close(words, x, ll, J, K)


def _team_log_density(words, x, J, K, n, G):
    """The fixed-shape team build's arithmetic (``csrc/warp.cuh::
    team_super_funnel_fixed``) in f32 on the CPU, from ``sf_team_pack``'s
    padded words at team size G: team lane t takes groups j = t + G r,
    reads alpha and the betas at offsets from its first group's and its
    observations from word SF_TEAM_HEAD + t kStride + G r kStride, sums
    them in order (:func:`_signed_group`); every lane then adds the J sums
    in index order, group j from lane j mod G, round j // G (the
    ``__shfl_sync`` reads), then the closing formula."""
    _, stride = _build.sf_team_stride(K, n)
    d = J + J * K + K + 3
    x = x.reshape(d, -1)
    held = {}
    for t in range(G):
        o = _build.SF_TEAM_HEAD + t * stride
        for r in range(-(-J // G)):
            if t + G * r >= J:
                continue
            og = o + G * r * stride
            b0 = J + t * K + G * r * K
            held[t, r] = _signed_group(
                words[og:og + n * (K + 1)].reshape(n, K + 1), x[t + G * r],
                x[b0:b0 + K], K)
    ll = torch.zeros_like(x[0])
    for j in range(J):
        ll = ll + held[j % G, j // G]
    return _close(words, x, ll, J, K)


def _close(words, x, ll, J, K):
    """The priors' squares in index order and the closing formula, from
    the head's words 3..9 (both builds' first words), -inf where a tau is
    at most 1e-9."""
    h = words[:_build.SF_HEAD]
    d, m = J + J * K + K + 3, J + J * K
    tau_a, tau_b = x[d - 2], x[d - 1]
    valid = (tau_a > 1e-9) & (tau_b > 1e-9)
    mu_a = x[m]
    sa = sb = smb = torch.zeros_like(tau_a)
    for j in range(J):
        sa = sa + (x[j] - mu_a) * (x[j] - mu_a)
    for j in range(J):
        for k in range(K):
            v = x[J + j * K + k] - x[m + 1 + k]
            sb = sb + v * v
    for k in range(K):
        smb = smb + x[m + 1 + k] * x[m + 1 + k]
    ta = torch.where(valid, tau_a, 1.0)
    tb = torch.where(valid, tau_b, 1.0)
    lp_a = (h[3] - float(J) * torch.log(ta)) - (0.5 * sa) / (ta * ta)
    lp_b = (h[4] - float(J * K) * torch.log(tb)) - (0.5 * sb) / (tb * tb)
    lp_ma = h[6] - (0.5 * (mu_a * mu_a)) / h[5]
    lp_mb = h[7] - (0.5 * smb) / h[5]
    qa, qb = ta / h[9], tb / h[9]
    lp_t = ((h[8] - torch.log1p(qa * qa)) + h[8]) - torch.log1p(qb * qb)
    total = ((((ll + lp_a) + lp_b) + lp_ma) + lp_mb) + lp_t
    return torch.where(valid, total, -torch.inf)


@pytest.mark.parametrize("cfg", CONFIGS[:2] + [(10, 3, 20, 3), (2, 1, 20, 5)]
                         + CONFIGS[2:],
                         ids=lambda c: "J{}K{}n{}s{}".format(*c))
def test_packed_dataset_gives_the_plain_log_density_bit_for_bit(cfg):
    """``sf_pack``'s signed covariates X' and signs sigma (X' = sigma X,
    sigma = -1 where Y = 1), run through the fixed-shape build's f32
    arithmetic on the CPU, give the plain ``log_density_td`` bit for bit
    on JAX's dataset (the reference's seed 42 first; the team shapes
    d = 68 and 166 last), -inf where a tau is at most 1e-9, and stay
    within RTOL of JAX's ``log_density``."""
    J, K, n, seed = cfg
    jt, pt = _pair(*cfg)
    words = _build.sf_pack(_build.kernel_target(pt)[1])
    obs = words[_build.SF_HEAD:].reshape(J, n, K + 1)
    sign = obs[..., K]
    np.testing.assert_array_equal(sign.numpy(), np.where(
        np.asarray(jt.Y) != 0, -1.0, 1.0))
    np.testing.assert_array_equal(
        obs[..., :K].numpy(), (pt.X_cols.reshape(J, K, n).permute(0, 2, 1)
                               * sign[..., None]).numpy())
    x = _states(jt, (3, 40), seed)
    ours = _fixed_log_density(words, torch.from_numpy(x), J, K, n).reshape(
        x.shape[1:])
    plain = pt.log_density_td(torch.from_numpy(x))
    assert torch.equal(ours, plain)
    ref = np.asarray(jt.log_density_td(jnp.asarray(x)))
    fin = np.isfinite(ref)
    assert not fin.all() and fin.mean() > 0.9
    np.testing.assert_array_equal(np.isfinite(ours.numpy()), fin)
    np.testing.assert_allclose(ours.numpy()[fin], ref[fin], rtol=RTOL)


@pytest.mark.parametrize("team", [4, 8, 32])
@pytest.mark.parametrize("cfg", CONFIGS[2:],
                         ids=lambda c: "J{}K{}n{}s{}".format(*c))
def test_team_arithmetic_gives_the_plain_log_density_bit_for_bit(cfg, team):
    """``sf_team_pack``'s padded words (the head to 12 words, each group
    to an odd number of 16- or 8-byte loads, zeros between), run through
    the team build's f32 arithmetic at team size G on the CPU (lane j mod
    G, the in-order sums), give the plain ``log_density_td`` bit for bit
    at d = 68 and 166, -inf where a tau is at most 1e-9, and stay within
    RTOL of JAX's ``log_density_td`` (run on the CPU as the JAX package's
    tests run it)."""
    J, K, n, seed = cfg
    jt, pt = _pair(*cfg)
    params = _build.kernel_target(pt)[1]
    packed, words = _build.sf_pack(params), _build.sf_team_pack(params)
    a, stride = _build.sf_team_stride(K, n)
    assert (a, stride) == ((2, 122) if K == 5 else (4, 84))
    assert words.numel() == _build.SF_TEAM_HEAD + J * stride
    assert torch.equal(words[:_build.SF_HEAD], packed[:_build.SF_HEAD])
    assert not words[_build.SF_HEAD:_build.SF_TEAM_HEAD].any()
    groups = words[_build.SF_TEAM_HEAD:].reshape(J, stride)
    assert torch.equal(groups[:, :n * (K + 1)],
                       packed[_build.SF_HEAD:].reshape(J, n * (K + 1)))
    assert not groups[:, n * (K + 1):].any()
    x = _states(jt, (3, 40), seed)
    ours = _team_log_density(words, torch.from_numpy(x), J, K, n,
                             team).reshape(x.shape[1:])
    assert torch.equal(ours, pt.log_density_td(torch.from_numpy(x)))
    ref = np.asarray(jt.log_density_td(jnp.asarray(x)))
    fin = np.isfinite(ref)
    assert not fin.all() and fin.mean() > 0.9
    np.testing.assert_array_equal(np.isfinite(ours.numpy()), fin)
    np.testing.assert_allclose(ours.numpy()[fin], ref[fin], rtol=RTOL)


@pytest.mark.parametrize("J,K,n,team", [(10, 5, 20, 4), (10, 5, 20, 32),
                                        (40, 3, 20, 8), (40, 3, 20, 32)])
def test_fixed_team_shared_bytes_mirror_the_layout(J, K, n, team):
    """A fixed team build's shared memory (``csrc/fused_*_warp.cu::
    shared_words`` with ``csrc/warp.cuh::row_dmax`` and ``kTeamRows``):
    two rows a team (no terms row) of the smallest multiple of 4 G that
    holds d + 4 words, plus G below G = 32, then the padded dataset; the
    run-time library keeps three rows of the bucket.  The pitch puts a
    warp's teams, and the stride a team's groups, on distinct banks.  At
    64 registers the fixed build holds 2 PT blocks of 16 replicas (32 warps
    an SM) and 4 RWM blocks at d = 68, G = 4; 2 of 7 replicas (28 warps)
    and 3 at d = 166, G = 8."""
    d = J + J * K + K + 3
    dmax, T = _build.warp_bucket(d), 8
    words = _build.sf_team_words(J, K, n)
    row = _build.sf_team_dmax(d, team)
    rows = _build.team_rows("super_funnel", fixed=True)
    assert rows == 2 and _build.team_rows("super_funnel") == 3
    assert row % (4 * team) == 0 and d + 4 <= row < d + 4 + 4 * team
    assert row == {(68, 4): 80, (68, 32): 128, (166, 8): 192,
                   (166, 32): 256}[d, team]
    pitch = _build.team_pitch(row, team)
    assert pitch == row + (team if team < 32 else 0)
    starts = [(k * pitch) % 32 for k in range(32 // team)]
    assert len(set(starts)) == len(starts)
    a, stride = _build.sf_team_stride(K, n)
    lanes = min(team, 32 // a)
    assert len({(t * stride) % 32 // a for t in range(lanes)}) == lanes
    for R in (1, 2, 7, 16):
        threads = _build.pt_block_threads(R, T, team)
        if threads > _build.pt_team_threads(dmax, team):
            continue
        misc = 2 * T + 2 * T * R + 5 * R + 3 * T * R + R
        for prop, lap in (("Normal", 0), ("Laplace", T * d)):
            assert _build.pt_warp_shared_bytes(
                words, T, d, R, row, prop, team, rows=rows) == 4 * (
                threads // team * 2 * pitch + words + misc + lap)
        params = _build.sf_words(J, K, n)   # the run-time vector
        assert _build.pt_warp_shared_bytes(
            params, T, d, R, dmax, "Normal", team, "super_funnel") == 4 * (
            threads // team * 3 * _build.team_pitch(dmax, team) + params
            + misc)
    for chains in (8, 32, 64):
        assert _build.rwm_warp_shared_bytes(
            words, d, chains, row, "Laplace", team,
            rows=rows) == 4 * (chains * 2 * pitch + words + d)
    if team < 32:
        g = _build.pt_warp_geometry(64, 512, d, row, T, 65536, "Normal",
                                    "lax_erfinv", words, team=team,
                                    rows=rows)
        r = _build.rwm_warp_geometry(64, 256, d, row, 65536, "Normal",
                                     "lax_erfinv", words, team=team,
                                     rows=rows)
        want = {68: ((16, 2), (64, 4)), 166: ((7, 2), (32, 3))}[d]
        assert ((g.replicas, g.blocks_per_sm),
                (r.replicas, r.blocks_per_sm)) == want
        assert g.shared_bytes == _build.pt_warp_shared_bytes(
            words, T, d, g.replicas, row, "Normal", team, rows=rows)


def test_fixed_shape_geometry_drops_the_stage_row_and_the_params():
    """A fixed-shape build takes no stage row (the proposal stays in
    registers) and no parameter words in shared memory (the dataset is a
    kernel parameter): at the reference's dataset (410 words, d = 26) its
    PT block is 33 words a thread and 410 words smaller, its RWM block
    likewise; the run-time library's counts are unchanged."""
    small = _build.sf_words(5, 3, 20)
    assert small == 10 + 15 * 20 + 5 * 20
    assert _build.row_words(32, kind="super_funnel", fixed=True) == \
        _build.row_words(32) == _build.row_words(32, kind="super_funnel") - 33
    run = _build.pt_shared_bytes(small, 8, 26, 32, 32, "Normal",
                                 "lax_erfinv", "super_funnel")
    fix = _build.pt_shared_bytes(small, 8, 26, 32, 32, "Normal",
                                 "lax_erfinv", "super_funnel", fixed=True)
    assert run - fix == 4 * (8 * 32 * 33 + small)
    assert fix == _build.pt_shared_bytes(0, 8, 26, 32, 32, "Normal",
                                         "lax_erfinv")
    assert _build.rwm_shared_bytes(small, 26, 128, 32, "Normal", "lax_erfinv",
                                   "super_funnel", fixed=True) == 4 * 128 * 36
    g = _build.pt_block_geometry(96, 320, 26, 32, 8, 65536, "Normal",
                                 "lax_erfinv", small, "super_funnel",
                                 fixed=True)
    assert g.shared_bytes == _build.pt_shared_bytes(
        small, 8, 26, g.replicas, 32, "Normal", "lax_erfinv", "super_funnel",
        fixed=True)
    r = _build.rwm_block_geometry(80, 128, 26, 32, 65536, "Normal",
                                  "lax_erfinv", small, "super_funnel",
                                  fixed=True)
    assert r.replicas == 128 and r.shared_bytes == 4 * 128 * 36


def test_ptxas_report_names_fixed_shape_instantiations():
    """ptxas's entry names of a fixed-shape build carry the dataset type's
    template arguments after the kernel's; the report names the kernel's
    own (bucket, and for PT R32 or Rrt)."""
    from rwm_pt_tpu_torch.kernels import ptxas_report
    sf = "16SuperFunnelFixedILi5ELi3ELi20ELi20EE"
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115fused"
        f"_pt_kernelILi12ELi32ELi32EEEvPKfiS2_{sf}' for 'sm_90a'",
        "ptxas info    : Used 96 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115fused"
        f"_pt_kernelILi12ELi32ELi0EEEvPKfiS2_{sf}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116fused"
        f"_rwm_kernelILi12ELi32EEEvPKfiffS2_{sf}' for 'sm_90a'",
        "ptxas info    : Used 80 registers"])
    assert ptxas_report.parse(log) == [("D32 R32", 96, 0, 0),
                                       ("D32 Rrt", 168, 8, 8),
                                       ("D32", 80, 0, 0)]
