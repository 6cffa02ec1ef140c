"""The fused kernels' widest warp buckets, 1020 < d <= 4092 (``.w2048``: d +
4 <= 2048 slots, ``.w4096``: d + 4 <= 4096; one warp a replica, G = 32;
PT's cluster builds ``.c2048`` / ``.c4096``) and the ladder kernel's
(``ladder_build.<kind>.d2048`` / ``.d4096``, the full MVN's warp form above
the 16 bucket): the lane layout through its Python mirror in
``kernels/_build.py`` at every d of the buckets, the rows' pitch, the
bucket edges and the refusal above 4092, ``rungs_fit`` for every kind and
proposal, the launch geometry against hand-counted bytes, and the plain
versions that the kernels are held against, step for step against the JAX
package's Pallas body on shared draws at d = 2000 and 4092 and SuperFunnel
at d = 1206, plus the harness's RWM rate at d = 2000 and the device
ladder's plain version against JAX's one-program builder on the iso MVN at
d = 2000 and the full MVN at d = 1100.  No card needed: the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase 22 hold the
kernels against these plain versions."""
import numpy as np
import pytest
import torch

from _torch_port_helpers import f32_sigmas, make_draws, rate_z, run_jax_body
from rwm_pt_tpu.api import MCMCSimulation as JSim
from rwm_pt_tpu.ladders.ladders import \
    construct_iterative_ladder_device as jdevice
from rwm_pt_tpu.targets import SuperFunnel as JSuperFunnel
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.api import MCMCSimulation
from rwm_pt_tpu_torch.convert import pt_state_from_numpy
from rwm_pt_tpu_torch.kernels import _build, draws, ladder_build, run_pt_fused
from rwm_pt_tpu_torch.ladders import construct_iterative_ladder_device
from rwm_pt_tpu_torch.targets import SuperFunnel
from rwm_pt_tpu_torch.targets import get_target_distribution as tget
from test_torch_wide import _hold_pt, _kinds, _spd

torch.set_num_threads(1)
CPU = "cpu"
RTOL = 1e-5
WIDER = (2048, 4096)       # the widest warp buckets, G = 32 alone
LOWEST = {2048: 1021, 4096: 2045}   # each bucket's least d


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("dmax", WIDER)
def test_every_slot_is_computed_by_one_lane_at_every_d(dmax):
    """For every d of the bucket (1021..2044, 2045..4092) at G = 32: slots
    0..d+3 each come from exactly one lane, the lane ``warp_slot_owner``
    names, in a trip its block loop has (16 quads a lane in the 2048
    bucket, 32 in the 4096); the lanes' block counts differ by at most
    one.  (The wide teams: tests/test_torch_wide_teams.py, PT's, and
    tests/test_torch_rwm_wide_teams.py, RWM's.)"""
    team = 32
    assert _build.library_teams(f"fused_pt.mvn_iso.w{dmax}") == (
        _build.WARP_TEAMS[dmax]) == ((32, 64) if dmax == 2048 else
                                     (32, 64, 128))
    assert _build.library_teams(f"fused_rwm.mvn_iso.w{dmax}") == (
        _build.WARP_TEAMS[dmax])
    nq = _build.team_quads(dmax, team)
    assert nq == dmax // 128
    for d in range(LOWEST[dmax], dmax - 3):
        assert _build.warp_bucket(d) == dmax
        blocks = _build.warp_blocks(d, dmax, team)
        n_blocks = (d + 3) // 4 + 1
        flat = sorted(q for qs in blocks.values() for q in qs)
        assert flat == list(range(n_blocks))
        assert all(q % team == lane for lane, qs in blocks.items()
                   for q in qs)
        assert 4 * n_blocks <= dmax
        counts = [len(qs) for qs in blocks.values()]
        assert max(counts) - min(counts) <= 1
        assert max(counts) == _build.block_trips(d, team) <= nq
    for j in range(dmax):
        lane, trip, word = _build.warp_slot_owner(j, team)
        assert 4 * (team * trip + lane) + word == j and trip < nq


@pytest.mark.parametrize("dmax", WIDER)
def test_box_muller_partners_stay_in_the_team_at_every_d(dmax):
    """At every d of the bucket: pair k (< h = ceil(d/2)) takes u1 from
    slot k and u2 from slot h + k (d + 3 for an odd d's last pair), each
    from the lane that owns it; coordinate h + k receives its sine from
    that lane, and an odd d's last pair writes none."""
    for d in range(LOWEST[dmax], dmax - 3):
        h = (d + 1) // 2
        s1, s2 = draws.bm_slots(d)
        assert list(s1) == list(range(h))
        want = [h + k if h + k < d else d + 3 for k in range(h)]
        assert list(s2) == want
        for k in (0, h // 2, h - 1):
            own, u2_lane, sine_lane = _build.bm_lanes(k, d)
            assert own == _build.warp_slot_owner(k)[0]
            assert u2_lane == _build.warp_slot_owner(want[k])[0]
            assert sine_lane == (u2_lane if h + k < d else -1)


@pytest.mark.parametrize("dmax", WIDER)
def test_wider_rows_pitch(dmax):
    """One warp a state and the wide teams of two and four: a row is the
    bucket's words (no pad), 16-byte aligned; G = 16 is not instantiated
    (its pitch, the bucket plus 16 words, holds no more rungs and half the
    warps).  G = 32's launch bound is 512 threads, 800 in the cluster
    build at most; the wide teams' 640 in both (G = 128 in the 4096 bucket
    only)."""
    assert _build.WARP_TEAMS[dmax] == ((32, 64) if dmax == 2048 else
                                       (32, 64, 128))
    assert _build.RWM_WARP_TEAMS[dmax] == _build.WARP_TEAMS[dmax]
    assert _build.team_pitch(dmax, 32) == dmax
    assert _build.team_pitch(dmax, 16) == dmax + 16
    assert _build.team_quads(dmax, 32) * 128 == dmax
    for g in _build.WARP_TEAMS[dmax][1:]:
        assert _build.team_pitch(dmax, g) == dmax
        assert _build.team_quads(dmax, g) * 4 * g == dmax
        assert _build.pt_team_threads(dmax, g) == 640
        assert _build.pt_team_threads(dmax, g, cluster=True) == 640
    assert _build.PT_WARP_MAX_WARPS[dmax] == 16
    assert _build.pt_team_threads(dmax, 32) == 512
    assert _build.pt_team_threads(dmax, 32, cluster=True) == \
        _build.PT_CLUSTER_THREADS


@pytest.mark.parametrize("d,dmax", [(1020, 1024), (1021, 2048), (2000, 2048),
                                    (2044, 2048), (2045, 4096),
                                    (4000, 4096), (4092, 4096)])
def test_bucket_edges(d, dmax):
    """Every library's name, source, flags and team sizes at the buckets'
    edges, PT's cluster build of the same bucket and the ladder kernel's
    library."""
    assert _build.warp_bucket(d) == dmax
    for v in ("fused_pt_lax_erfinv", "fused_rwm_laplace",
              "fused_pt_uniform_radius_bm", "fused_rwm_lax_erfinv"):
        name = _build.lib_name(v, "mvn_full", d)
        assert name == f"{v}.mvn_full.w{dmax}" and _build.is_warp(name)
        src, _, _, _, bucket, blocks = _build._parts(name)
        assert src.endswith("_warp") and (bucket, blocks) == (dmax, 1)
        teams = _build.library_teams(name)
        assert 32 in teams and (dmax <= 1024
                                or teams == _build.WARP_TEAMS[dmax])
        assert {f"-DRWM_PT_DMAX={dmax}", f"-DRWM_PT_TEAMS={sum(teams)}"} \
            <= set(_build._flags(name))
        if v.startswith("fused_pt"):
            c = _build.cluster_lib(name)
            assert c == f"{v}.mvn_full.c{dmax}" and _build.is_cluster(c)
            assert "-DRWM_PT_CLUSTER=1" in _build._flags(c)
    for kind in ("mvn_full", "mvn_iso", "iid_beta"):
        lib = _build.ladder_lib(kind, d)
        assert lib == f"ladder_build.{kind}.d{dmax}"
        assert f"-DRWM_PT_DMAX={dmax}" in _build._flags(lib)
    assert ladder_build.full_warp("mvn_full", d)
    assert not ladder_build.full_warp("mvn_iso", d)
    assert ladder_build.full_words(d, 3000) == 3 * d * d + 6000


@pytest.mark.parametrize("d", [4093, 4096, 5000])
def test_above_4092_raises_naming_the_remainder(d):
    """No bucket above 4092: every library name, the target check, the
    ladder's library and the harness refuse, naming ROADMAP Queue A item
    15 and what sets the limit (the next bucket's rows)."""
    for fn in (lambda: _build.warp_bucket(d),
               lambda: _build.lib_name("fused_rwm", "mvn_iso", d),
               lambda: _build.ladder_lib("mvn_full", d),
               lambda: _build.kernel_target(tget("FullRosenbrock", d,
                                                 device=CPU))):
        with pytest.raises(NotImplementedError) as e:
            fn()
        assert "Queue A item 15" in str(e.value)
        assert "above d = 4092" in str(e.value) and "rows" in str(e.value)
    sim = MCMCSimulation(dim=d, sigma=0.01, num_iterations=2,
                         target_dist=tget("FullRosenbrock", d, device=CPU),
                         num_chains=2, device=CPU)
    assert "Queue A item 15" in sim._fused_refusal()


# ------------------------------------------------------------ the fit
def _n_params(kind, d):
    if kind == "super_funnel":
        return _build.PARAMS_SHARED_MAX
    if kind == "mvn_full":
        return 1 + d + d * d
    return {"mvn_iso": 1 + d}.get(kind, 3 * d + 8)


@pytest.mark.parametrize("d", [2044, 4092])
def test_rungs_fit_is_at_least_24(d):
    """``rungs_fit`` is at least 24 for every kind and proposal at the
    buckets' largest d (56 up to 2044), with the layout named: one warp a
    rung-team over a cluster of eight blocks, by the block's shared
    memory; T fits ``pt_cluster_geometry``, T + 1 does not.  Up to 1020
    the floor stays 64.  The cluster build's rung-teams keep two rows in
    shared memory for every kind (the terms row in global memory), so the
    fit is 88 rungs at d = 2044 and 40 at 4092 (56 and 24 with three
    rows)."""
    floor = 56 if d <= 2044 else 24
    dmax = _build.warp_bucket(d)
    for kind in _build.TARGET_KINDS:
        for prop in _build.PROPOSALS:
            for n in (_n_params(kind, d), None):
                fit = _build.rungs_fit(d, kind, prop, n)
                assert fit.rungs >= floor, (kind, prop, fit)
                assert fit.layout.startswith(
                    "teams of 32 lanes over a cluster of 8 blocks")
                assert fit.layout.endswith("by its shared memory")
                words = _build.PARAMS_SHARED_MAX if n is None else n
                kw = dict(n_params=words, team=32, kind=kind)
                cap = _build.PT_CLUSTER_THREADS
                _build.pt_cluster_geometry(64, cap, d, dmax, fit.rungs, 1,
                                           prop, **kw)
                with pytest.raises(ValueError):
                    _build.pt_cluster_geometry(64, cap, d, dmax,
                                               fit.rungs + 1, 1, prop, **kw)
    assert _build.max_rungs(d) == {2044: 88, 4092: 40}[d] >= floor
    assert min(_build.max_rungs(1020, k) for k in _build.TARGET_KINDS) >= 64


# ------------------------------------------------------------ geometry
def _sweep_words(T, R):
    """The PT blocks' words beside the rows and the parameters: the
    ladder, the sweep's lp and u, the per-replica sums, the maps, the
    accepts, the owners (csrc/fused_pt_warp.cu::shared_words)."""
    return 2 * T + 2 * T * R + 5 * R + 3 * T * R + R


def test_pt_geometry_at_d2000_and_4000():
    """T = 10 at 65,536 replicas.  d = 2000: the iso MVN's ten rung-teams
    of 2 x 8 KB rows and its 2001 staged words fill one block (320
    threads, 172,148 B), one an SM; a three-row kind (the full MVN, its
    precision through L2) runs over a cluster of 2 blocks of 5.  d = 4000:
    the iso MVN over 2 blocks of 5 rung-teams (2 x 16 KB rows, 180,148 B),
    the full MVN over 3 blocks of 4 (3 x 16 KB, 196,912 B), IIDGamma (its
    12,008 words staged beside three rows) over 4 blocks of 3."""
    g = _build.pt_warp_geometry(64, 512, 2000, 2048, 10, 65536,
                                n_params=2001)
    assert (g.replicas, g.threads, g.blocks_per_sm, g.grid) == (1, 320, 1,
                                                               65536)
    assert g.shared_bytes == 4 * (10 * 2 * 2048 + 2001 + _sweep_words(10, 1))
    assert g.shared_bytes == 172148
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(64, 512, 2000, 2048, 10, 65536,
                                n_params=1 + 2000 + 2000 ** 2, rows=3)
    g = _build.pt_cluster_geometry(64, 512, 2000, 2048, 10, 65536,
                                   n_params=1 + 2000 + 2000 ** 2, rows=3)
    assert (g.cluster, g.slots, g.replicas, g.threads) == (2, 5, 1, 160)
    assert g.shared_bytes == 4 * (5 * 3 * 2048 + _sweep_words(10, 1))
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(64, 512, 4000, 4096, 10, 65536,
                                n_params=4001)
    g = _build.pt_cluster_geometry(64, 512, 4000, 4096, 10, 65536,
                                   n_params=4001)
    assert (g.cluster, g.slots, g.replicas, g.threads, g.grid) == (
        2, 5, 1, 160, 131072)
    assert g.shared_bytes == 4 * (5 * 2 * 4096 + 4001 + _sweep_words(10, 1))
    assert g.shared_bytes == 180148
    g = _build.pt_cluster_geometry(64, 512, 4000, 4096, 10, 65536,
                                   n_params=1 + 4000 + 4000 ** 2, rows=3)
    assert (g.cluster, g.slots, g.replicas, g.threads) == (3, 4, 1, 128)
    assert g.shared_bytes == 4 * (4 * 3 * 4096 + _sweep_words(10, 1)) \
        == 196912
    g = _build.pt_cluster_geometry(64, 512, 4000, 4096, 10, 65536,
                                   n_params=3 * 4000 + 8, rows=3)
    assert (g.cluster, g.slots) == (4, 3)
    assert g.shared_bytes == 4 * (3 * 3 * 4096 + 12008 + _sweep_words(10, 1))
    # Laplace's (T, d) scales are read through L2 in the cluster build
    g = _build.pt_cluster_geometry(64, 512, 4000, 4096, 10, 65536,
                                   "Laplace", n_params=4001)
    assert g.shared_bytes == 180148


@pytest.mark.parametrize("C", [512, 65536])
def test_rwm_geometry_at_d2000_and_4000(C):
    """RWM at 65,536 chains: 8 chains a block at d = 2000 (2 x 8 KB rows
    each, 139,076 B), 6 at d = 4000 (2 x 16 KB, 212,612 B), 4 of the full
    MVN (3 x 16 KB, 196,608 B): one block an SM; 512 chains take fewer a
    block so that the grid covers the card."""
    g = _build.rwm_warp_geometry(64, 256, 2000, 2048, C, n_params=2001)
    assert g.replicas == (8 if C == 65536 else 3) and g.team == 32
    assert g.shared_bytes == 4 * (g.replicas * 2 * 2048 + 2001)
    g = _build.rwm_warp_geometry(64, 256, 4000, 4096, C, n_params=4001)
    assert g.replicas == (6 if C == 65536 else 3)
    assert g.shared_bytes == 4 * (g.replicas * 2 * 4096 + 4001)
    if C == 65536:
        assert g.shared_bytes == 212612 and g.blocks_per_sm == 1
    g = _build.rwm_warp_geometry(64, 256, 4000, 4096, C,
                                 n_params=1 + 4000 + 4000 ** 2, rows=3)
    assert g.replicas == (4 if C == 65536 else 3)
    assert g.shared_bytes == 4 * g.replicas * 3 * 4096


# ------------------------------------------------------------ plain versions
WIDER_KINDS = [k for k in _kinds(2000)]


def _lp_atol(d):
    """The log-densities' absolute tolerance at d coordinates: the two
    packages sum d float32 terms in their own orders, and some kinds'
    partial sums and constants (ThreeMixture's 0.5 d log 2 pi, 1838 at
    d = 2000) are larger than lp itself, so rtol 1e-5 of those terms:
    1e-5 x 0.5 d log(2 pi) (0.018 at d = 2000).  x, the counters and the
    Kahan sums are held at rtol 1e-5 as at the narrower d."""
    return 1e-5 * 0.5 * d * np.log(2 * np.pi)


@pytest.mark.parametrize("kind", WIDER_KINDS)
def test_fused_pt_plain_matches_pallas_body_at_d2000(monkeypatch, kind):
    """Every kind but SuperFunnel at d = 2000 (the 2048 bucket), the full
    MVN among them: the plain fused PT version, which the ``.w2048`` /
    ``.c2048`` kernels are held against, step for step against
    ``pallas_pt.py::_pt_body_fn`` (counts exact, floats to rtol 1e-5;
    the full MVN's correlated target on 8 replicas, so that some move is
    accepted in 4 steps)."""
    _hold_pt(monkeypatch, kind, 2000, T=2, C=8 if kind == "mvn_full" else 4,
             S=4, lp_atol=_lp_atol(2000))


@pytest.mark.parametrize("prop", ["Laplace", "UniformRadius"])
def test_fused_pt_plain_proposals_match_pallas_body_at_d2000(monkeypatch,
                                                            prop):
    """Laplace (per-rung (T, d) scales) and UniformRadius (per-rung radii)
    at d = 2000 on the iso MVN; the Normal proposal is the kinds' test."""
    _hold_pt(monkeypatch, "mvn_iso", 2000, prop, T=2, C=6, S=4,
             lp_atol=_lp_atol(2000))


@pytest.mark.parametrize("kind", ["mvn_iso", "rosenbrock", "iid_gamma"])
def test_fused_pt_plain_matches_pallas_body_at_d4092(monkeypatch, kind):
    """The iso MVN, FullRosenbrock and IIDGamma at d = 4092, the 4096
    bucket's largest d (sums over 4092 terms)."""
    _hold_pt(monkeypatch, kind, 4092, T=2, C=3, S=3, lp_atol=_lp_atol(4092))


def test_super_funnel_at_d1206_plain_matches_pallas_body(monkeypatch):
    """SuperFunnel at J = 300, K = 3, n = 20 (d = 1206, the 2048 bucket;
    its dataset over the shared-memory budget, so the run-time-shape
    library takes it): the dataset bit for bit, and the plain fused PT
    version step for step against the Pallas body from states near the
    prior (counts exact, floats to rtol 1e-5)."""
    jt = JSuperFunnel.create_synthetic(300, 3, 20, seed=42)
    pt = SuperFunnel.create_synthetic(300, 3, 20, seed=42, device=CPU)
    assert pt.dim == jt.dim == 1206
    np.testing.assert_array_equal(pt.X_cols.numpy(), np.asarray(jt.X_cols))
    for v in ("fused_pt_lax_erfinv", "fused_rwm_lax_erfinv"):
        assert _build.route(v, pt)[0] == f"{v}.super_funnel.w2048"
    d, T, C, S = 1206, 2, 4, 4
    rng = np.random.default_rng(8)
    x0 = (0.1 * rng.normal(size=(d, T, C))).astype(np.float32)
    x0[-2:] = np.abs(x0[-2:]) + np.float32(0.5)   # the taus, valid
    betas = np.asarray([1.0, 0.5], np.float32)
    var = 1e-4
    dr = make_draws(13, S, T, d, C)
    import jax.numpy as jnp
    lp0 = np.asarray(jt.log_density_td(jnp.asarray(x0)))
    assert np.isfinite(lp0).all()
    ref = run_jax_body(monkeypatch, jt, x0, betas, f32_sigmas(var, betas),
                       dr, 0, 1, 2)
    z = np.zeros(C, np.float32)
    state = pt_state_from_numpy(dict(
        x=x0, logp=lp0, accept_count=np.zeros((T, C), np.int32),
        swap_attempt_count=0, swap_accept_count=np.zeros(C, np.int32),
        sum_beta_sq_jump=z, sum_sq_jump_cold=z, step=0), device=CPU)
    st = run_pt_fused(pt, 0, betas, base_variance=var, num_chains=C,
                      num_iterations=S, burn_in=1, swap_every=2,
                      resume_state=state, device=CPU,
                      draws=tuple(torch.from_numpy(a) for a in dr)).state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2])
    np.testing.assert_array_equal(st.swap_accept_count.numpy(), ref[3])
    np.testing.assert_allclose(st.x.numpy(), ref[0], rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=1e-6)
    assert (st.accept_count.numpy() > 0).any()


def test_harness_rwm_rate_at_d2000_matches_jax():
    """``MCMCSimulation`` RWM on the iso MVN at d = 2000 (the fused path's
    plain version on the CPU, ``engine_used`` "pallas") against the JAX
    harness's scan engine: per-chain acceptance and ESJD within 5
    Monte-Carlo standard errors at the scale 2.38^2 / d."""
    kw = dict(dim=2000, sigma=2.38 ** 2 / 2000, num_iterations=150,
              algorithm="RWM", target_dist="MultivariateNormal", seed=5,
              burn_in=50, num_chains=48, record_chain=False)
    js = JSim(**kw, engine="scan")
    ts = MCMCSimulation(**kw, device=CPU)
    js.generate_samples(verbose=False)
    ts.generate_samples(verbose=False)
    assert ts.engine_used == "pallas" and js.engine_used == "scan"
    a, b = ts.acceptance_rate_per_chain(), js.acceptance_rate_per_chain()
    assert float(np.mean(a)) > 0.02
    assert rate_z(a, b) < 5
    assert rate_z(ts.expected_squared_jump_distance_per_chain(),
                  js.expected_squared_jump_distance_per_chain()) < 5


# ------------------------------------------------------------ the ladder
def test_device_ladder_plain_matches_jax_on_the_iso_mvn_at_d2000():
    """The ladder kernel's plain version (the ``.d2048`` library's) on the
    iso MVN at d = 2000 against JAX's one-program builder with its own
    draws: the same rungs, each beta within 5 %."""
    kw = dict(target_swap_acceptance_rate=0.3, N_samples_swap_est=1000,
              tolerance=0.03, beta_min=0.3, max_pn_adjustment_steps=30,
              seed=4, max_T=3)
    j = jdevice(jget("MultivariateNormal", 2000), **kw)
    tg = tget("MultivariateNormal", 2000, device=CPU)
    assert _build.ladder_lib("mvn_iso", 2000) == "ladder_build.mvn_iso.d2048"
    t = construct_iterative_ladder_device(tg, **kw)
    assert len(t) == len(j) == 3 and t[-1] == pytest.approx(0.3)
    np.testing.assert_allclose(t, j, rtol=0.05)


def test_device_ladder_plain_matches_jax_on_the_full_mvn_at_d1100():
    """The full MVN's ladder above 1020 (the ``.d2048`` library's warp
    form): its plain version at d = 1100 against JAX's one-program builder
    with its own draws, as the d = 10 holds hold the kinds: the same rungs,
    each beta within 5 %."""
    cov = _spd(1100, seed=6)
    kw = dict(target_swap_acceptance_rate=0.3, N_samples_swap_est=1000,
              tolerance=0.03, beta_min=0.3, max_pn_adjustment_steps=30,
              seed=2, max_T=4)
    j = jdevice(jget("MultivariateNormal", 1100, cov=cov), **kw)
    tg = tget("MultivariateNormal", 1100, cov=cov, device=CPU)
    assert _build.target_kind(tg) == "mvn_full"
    assert ladder_build.full_warp("mvn_full", tg.dim)
    t = construct_iterative_ladder_device(tg, **kw)
    assert len(t) == len(j) == 4 and t[-1] == pytest.approx(0.3)
    np.testing.assert_allclose(t, j, rtol=0.05)
