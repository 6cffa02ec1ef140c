"""The fused kernels' wide warp buckets, 252 < d <= 1020 (``.w512``: d + 4
<= 512 slots, ``.w1024``: d + 4 <= 1024; a team of G = 16 or 32 lanes a
replica, ``csrc/warp.cuh``) and the ladder kernel's (``ladder_build.<kind>.
d512`` / ``.d1024``): the lane layout through its Python mirror in
``kernels/_build.py`` at every d of the buckets, the rows' pitch and banks,
the bucket edges, the launch geometry and ``max_rungs`` for every kind and
proposal, and the plain versions that the kernels are held against, step
for step against the JAX package's Pallas body on shared draws at d = 300,
600 and 1000, plus the harness's RWM rate at d = 500, the device ladder's
plain version at d = 300 (and both device builders on the tempered funnel,
whose float32 overflow they share) and SuperFunnel at d = 406.  No card
needed: the
card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase 20
hold the kernels against these plain versions."""
import dataclasses
import math
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (f32_sigmas, make_draws,
                                 make_proposal_draws, rate_z, run_jax_body)
from rwm_pt_tpu.api import MCMCSimulation as JSim
from rwm_pt_tpu.ladders.ladders import \
    construct_iterative_ladder_device as jdevice
from rwm_pt_tpu.targets import SuperFunnel as JSuperFunnel
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.api import MCMCSimulation
from rwm_pt_tpu_torch.convert import (pt_state_from_numpy,
                                      rwm_state_from_numpy, target_from_numpy)
from rwm_pt_tpu_torch.kernels import (_build, draws, run_pt_fused,
                                      run_rwm_fused)
from rwm_pt_tpu_torch.kernels.fused_pt import rung_scales
from rwm_pt_tpu_torch.ladders import construct_iterative_ladder
from rwm_pt_tpu_torch.ladders import ladders as L
from rwm_pt_tpu_torch.proposals import LaplaceProposal, UniformRadiusProposal
from rwm_pt_tpu_torch.targets import SuperFunnel
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6   # the plain versions' floats against JAX's
WIDE = (512, 1024)        # the wide warp buckets
INSTANTIATED = [(dmax, g) for dmax in WIDE for g in _build.WARP_TEAMS[dmax]]


def _spd(d, seed=5):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return (a @ a.T / d + np.eye(d)).astype(np.float32)


# kernel kind -> (registry name, registry kwargs at d, Normal variance
# times d) for the step-for-step holds at d = 300 (HybridRosenbrock's
# blocks: d = 1 + n2 (n1 - 1))
def _kinds(d):
    return {
        "rosenbrock": ("FullRosenbrock", {}, 0.25),
        "mvn_iso": ("MultivariateNormal", {}, 2.38 ** 2),
        "mvn_full": ("MultivariateNormal", {"cov": _spd(d)},
                     1.5 * 2.38 ** 2),
        "scaled_mvn": ("MultivariateNormalScaled", {}, 0.25 * 2.38 ** 2),
        "three_mixture": ("ThreeMixtureScaled", {}, 2.38 ** 2),
        "rough_carpet": ("RoughCarpetScaled", {}, 0.25 * 2.38 ** 2),
        "even_rosenbrock": ("EvenRosenbrock", {}, 0.5 ** 2),
        "hybrid_rosenbrock": ("HybridRosenbrock",
                              {"n1": 2, "n2": d - 1}, 0.03),
        "hypercube": ("Hypercube", {}, 2.38 ** 2 / 3),
        "iid_gamma": ("IIDGamma", {}, 18 * 2.38 ** 2),
        "iid_beta": ("IIDBeta", {}, 0.04 * 2.38 ** 2),
        "neal_funnel": ("NealFunnel", {}, 2.38 ** 2),
    }


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("dmax,team", INSTANTIATED)
def test_every_slot_is_computed_by_one_lane_at_every_d(dmax, team):
    """For every d of the bucket (253..508, 509..1020) at each of its team
    sizes: slots 0..d+3 (the increments, the MH, swap and radius uniforms,
    Box-Muller's odd-d angle) each come from exactly one lane, the lane
    ``warp_slot_owner`` names, in a trip its block loop has; the lanes'
    block counts differ by at most one and never exceed the bucket's quads
    a lane (8 at G = 32 in the 1024 bucket, 16 at G = 16)."""
    nq = _build.team_quads(dmax, team)
    assert nq == dmax // (4 * team)
    for d in range(dmax // 2 - 3, dmax - 3):
        assert _build.warp_bucket(d) == dmax
        blocks = _build.warp_blocks(d, dmax, team)
        assert set(blocks) == set(range(team))
        seen = {}
        for lane, qs in blocks.items():
            for q in qs:
                assert q % team == lane
                for j in range(4 * q, 4 * q + 4):
                    assert j not in seen
                    seen[j] = lane
        assert sorted(seen) == list(range(4 * ((d + 3) // 4 + 1)))
        assert max(seen) < dmax
        for j in range(d + 4):
            lane, trip, word = _build.warp_slot_owner(j, team)
            assert seen[j] == lane and trip < nq
            assert 4 * (team * trip + lane) + word == j
        counts = [len(qs) for qs in blocks.values()]
        assert max(counts) - min(counts) <= 1
        assert max(counts) == _build.block_trips(d, team) <= nq


@pytest.mark.parametrize("dmax,team", INSTANTIATED)
def test_box_muller_partners_stay_in_the_team_at_every_d(dmax, team):
    """Pair k (< h = ceil(d/2)) takes u1 from slot k and u2 from
    ``draws.bm_slots``' slot h + k (d + 3 for an odd d's last pair), both
    in lanes of the team; each coordinate of [h, d) receives exactly one
    sine, from pair i - h, written by the lane that alone reads its slot."""
    for d in range(dmax // 2 - 3, dmax - 3):
        h = (d + 1) // 2
        s1, s2 = draws.bm_slots(d)
        sines = []
        for k in range(h):
            own, u2_lane, sine_lane = _build.bm_lanes(k, d, team)
            assert own == _build.warp_slot_owner(int(s1[k]), team)[0]
            assert u2_lane == _build.warp_slot_owner(int(s2[k]), team)[0]
            assert 0 <= own < team and 0 <= u2_lane < team
            if k + h < d:
                assert sine_lane == u2_lane
                sines.append(k + h)
            else:
                assert sine_lane == -1 and d % 2 and int(s2[k]) == d + 3
        assert sines == list(range(h, d)), d


@pytest.mark.parametrize("dmax,team,pitch", [(512, 16, 528), (512, 32, 512),
                                             (1024, 16, 1040),
                                             (1024, 32, 1024)])
def test_wide_rows_pitch_and_banks(dmax, team, pitch):
    """A team's rows are the bucket's words, plus G below G = 32, so that
    the two teams of a warp at G = 16 start on distinct banks; every row
    starts 16-byte aligned (float4 accesses)."""
    assert _build.team_pitch(dmax, team) == pitch
    assert len({(j * pitch) % 32 for j in range(32 // team)}) == 32 // team
    assert pitch * 4 % 16 == 0
    assert _build.team_quads(dmax, team) * 4 * team == dmax
    with pytest.raises(ValueError, match="no team"):
        _build.team_quads(dmax, 64)


@pytest.mark.parametrize("d,dmax", [(252, 256), (253, 512), (500, 512),
                                    (508, 512), (509, 1024), (1000, 1024),
                                    (1020, 1024)])
def test_bucket_edges(d, dmax):
    """Every library's name, source, flags and team sizes at the buckets'
    edges (in the wide buckets RWM's one warp a chain alone); the ladder
    kernel's library of the same bucket."""
    assert _build.warp_bucket(d) == dmax
    for v in ("fused_pt_lax_erfinv", "fused_rwm_laplace",
              "fused_pt_uniform_radius_bm"):
        name = _build.lib_name(v, "iid_beta", d)
        assert name == f"{v}.iid_beta.w{dmax}" and _build.is_warp(name)
        assert _build.launch_key(name) == name
        src, _, _, _, bucket, blocks = _build._parts(name)
        assert (src, bucket, blocks) == (v.split("_")[0] + "_"
                                         + v.split("_")[1] + "_warp",
                                         dmax, 1)
        teams = _build.library_teams(name)
        assert teams == (_build.RWM_WARP_TEAMS[dmax] if "rwm" in v
                         and dmax > 256 else _build.WARP_TEAMS[dmax])
        assert 32 in teams
        assert {f"-DRWM_PT_DMAX={dmax}", f"-DRWM_PT_TEAMS={sum(teams)}"} \
            <= set(_build._flags(name))
    assert _build.ladder_lib("mvn_iso", d) == f"ladder_build.mvn_iso.d{dmax}"
    assert f"-DRWM_PT_DMAX={dmax}" in _build._flags(
        _build.ladder_lib("neal_funnel", d))


@pytest.mark.parametrize("d", [4093, 4096, 8000])
def test_above_1020_raises_naming_the_remainder(d):
    """No bucket above 4092 dimensions (the 4096-slot bucket): every
    library name, the kernels' target check and the ladder's library raise
    ``NotImplementedError`` naming A15's remainder and what sets it; there
    is no fallback."""
    with pytest.raises(NotImplementedError, match="Queue A item 15"):
        _build.warp_bucket(d)
    with pytest.raises(NotImplementedError, match="above d = 4092"):
        _build.lib_name("fused_pt", "mvn_iso", d)
    with pytest.raises(NotImplementedError, match="rows"):
        _build.lib_name("fused_rwm", "mvn_full", d)
    with pytest.raises(NotImplementedError, match="4092"):
        _build.ladder_lib("mvn_iso", d)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _build.kernel_target(tget("FullRosenbrock", d, device=CPU))


# ------------------------------------------------------------ geometry
def _n_params(kind, d):
    """The parameter words of kind ``kind``'s registry target at d."""
    if kind == "super_funnel":
        return _build.PARAMS_SHARED_MAX       # the most a block stages
    if kind == "mvn_full":
        return 1 + d + d * d                  # read through L2 above d = 110
    name, kw, _ = _kinds(d)[kind]
    return _build.kernel_target(tget(name, d, device=CPU, **kw))[1].numel()


@pytest.mark.parametrize("proposal", list(_build.PROPOSALS))
@pytest.mark.parametrize("d", [500, 1000, 1020])
def test_max_rungs_is_the_geometry_fit(d, proposal):
    """``max_rungs(d, kind, proposal)`` is the most rungs for which
    ``pt_cluster_geometry`` fits one replica over a cluster of at most
    eight blocks at one of the bucket's team sizes: T = max_rungs fits,
    T + 1 fits none, and it is at least 64; T = 10 fits one block at
    d = 1020 for every kind and proposal, with the kind's words or the
    most a block stages.  At d = 252 every kind takes at least 64."""
    dmax = _build.warp_bucket(d)
    for kind in _build.TARGET_KINDS:
        n = _n_params(kind, d) if d != 1020 else None
        T = _build.max_rungs(d, kind, proposal, n)
        words = _build.PARAMS_SHARED_MAX if n is None else n

        def fits(T, geometry=_build.pt_cluster_geometry):
            ok = []
            for g in _build.WARP_TEAMS[dmax]:
                try:
                    geo = geometry(
                        64, _build.pt_team_threads(
                            dmax, g, geometry is _build.pt_cluster_geometry),
                        d, dmax, T, 65536, proposal, n_params=words, team=g,
                        kind=kind)
                    ok.append(geo)
                except ValueError:
                    pass
            return ok

        assert T >= 64, (kind, T)
        assert fits(T) and fits(10, _build.pt_warp_geometry)
        assert all(g.cluster <= _build.CLUSTER_MAX for g in fits(T))
        assert not fits(T + 1), (kind, T)
        assert _build.max_rungs(d, kind, proposal) <= T   # most words
        assert _build.max_rungs(252, kind, proposal) >= 64
    assert _build.max_rungs(d, None, proposal) == min(
        _build.max_rungs(d, k, proposal) for k in _build.TARGET_KINDS)


def test_pt_warp_geometry_in_the_wide_buckets():
    """T = 10 rung-teams at the main shape: in the 512 bucket G = 16 takes
    one replica a block (5 warps, 42 KB of rows), five blocks an SM; in the
    1024 bucket (8 KB of rows a state) G = 16 one block of two replicas
    (166 KB; two blocks of one hold as many threads).  The 1024 bucket's
    G = 32 (16 warps at most) refuses 17 rungs; G = 16 takes 26 of a
    two-row kind in one block, and eight such blocks of a cluster 208."""
    g = _build.pt_warp_geometry(64, 512, 500, 512, 10, 65536, n_params=501,
                                team=16)
    assert (g.replicas, g.threads, g.blocks_per_sm) == (1, 160, 5)
    assert g.shared_bytes == 4 * (10 * 2 * 528 + 501 + 20 + 20 + 5 + 30 + 1)
    g = _build.pt_warp_geometry(64, 512, 1000, 1024, 10, 65536,
                                n_params=1001, team=16)
    assert (g.replicas, g.threads, g.blocks_per_sm) == (2, 320, 1)
    g = _build.pt_warp_geometry(64, 512, 1000, 1024, 16, 65536,
                                n_params=1001, team=32)
    assert (g.replicas, g.threads) == (1, 512)
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(64, 512, 1000, 1024, 17, 65536,
                                n_params=1001, team=32)
    assert _build.max_rungs(1000, "mvn_iso", "Normal", 1001) == 8 * 26
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(64, 512, 1000, 1024, 27, 65536,
                                n_params=1001, team=16)


@pytest.mark.parametrize("C", [1, 512, 65536])
def test_rwm_warp_geometry_in_the_wide_buckets(C):
    """RWM blocks of the wide buckets hold whole warps of teams within 256
    threads and a block's shared memory, and cover the SMs where C
    allows."""
    for dmax, g in INSTANTIATED:
        d = dmax - 8
        geo = _build.rwm_warp_geometry(64, 256, d, dmax, C, n_params=d + 1,
                                       team=g)
        assert geo.team == g and geo.threads % 32 == 0
        assert geo.threads <= 256 and geo.shared_bytes <= _build.BLOCK_SHARED
        assert geo.shared_bytes == 4 * (geo.replicas * 2
                                        * _build.team_pitch(dmax, g) + d + 1)
        assert geo.grid == -(-C // geo.replicas)


def test_harness_refuses_rungs_beyond_the_fit():
    """``MCMCSimulation`` names the fit's rungs and the layout that sets
    them: 208 at d = 1000 on the iso MVN, teams of 16 lanes, 26 a block
    over a cluster of 8 blocks, under Laplace too (its scales read through
    L2); 256 at d = 500, 32 a block by its threads; a ladder within them
    is taken."""
    kw = dict(num_iterations=2, algorithm="PT", num_chains=2,
              target_dist="MultivariateNormal", device=CPU)
    shared = ("teams of 16 lanes over a cluster of 8 blocks, 26 rung-teams "
              "a block by its shared memory")
    assert MCMCSimulation(dim=1000, sigma=0.01, beta_ladder=[1.0] * 208,
                          **kw)._fused_refusal() is None
    assert MCMCSimulation(dim=1000, sigma=0.01, beta_ladder=[1.0] * 209,
                          **kw)._fused_refusal() == \
        f"at most 208 rungs ({shared})"
    lap = {"name": "Laplace", "params": {"base_variance_vector": 0.01}}
    assert MCMCSimulation(dim=1000, proposal_config=lap,
                          beta_ladder=[1.0] * 209,
                          **kw)._fused_refusal() == \
        f"at most 208 rungs ({shared})"
    assert MCMCSimulation(dim=500, sigma=0.01, beta_ladder=[1.0] * 256,
                          **kw)._fused_refusal() is None
    assert MCMCSimulation(dim=500, sigma=0.01, beta_ladder=[1.0] * 257,
                          **kw)._fused_refusal() == (
        "at most 256 rungs (teams of 16 lanes over a cluster of 8 blocks, "
        "32 rung-teams a block by its threads)")


def test_pt_launch_refuses_rungs_beyond_the_fit():
    """The PT wrapper refuses a ladder over ``target_max_rungs`` before it
    builds or launches anything, naming the fit and the layout that sets
    it (a cluster of eight blocks of teams)."""
    from rwm_pt_tpu_torch.kernels.fused_pt import launch_pt_kernel
    tg = tget("MultivariateNormal", 1000, device=CPU)
    T, C = 209, 2
    z = torch.zeros
    with pytest.raises(NotImplementedError,
                       match=r"at most 208 rungs .*cluster of 8 blocks.*"
                             r"T=209"):
        launch_pt_kernel(tg, z(1000, T, C), z(T, C, dtype=torch.int32),
                         z(C, dtype=torch.int32), z(C), z(C), torch.ones(T),
                         torch.ones(T), (1, 2), 0, 1, 0, 1)
    assert not launch_pt_kernel.launches


# ------------------------------------------------------------ plain versions
def _pair(kind, d):
    """(JAX target, the port's target built from its fields, variance)."""
    name, kw, var_d = _kinds(d)[kind]
    jt = jget(name, d, **kw)
    fields = {f.name: (np.asarray(getattr(jt, f.name))
                       if isinstance(getattr(jt, f.name), jax.Array)
                       else getattr(jt, f.name))
              for f in dataclasses.fields(jt)}
    pt = target_from_numpy(type(jt).__name__, fields, device=CPU)
    assert pt.dim == jt.dim == d
    return jt, pt, var_d / d


def _start(kind, jt, shape, seed):
    n = int(np.prod(shape))
    x = np.asarray(jt.init_sample(jax.random.key(seed), n)).T
    if kind not in ("hypercube", "iid_gamma", "iid_beta"):
        # the iso MVN near its stationary law (a start near its mode
        # accepts a few percent of the moves at d = 1000)
        sd = 1.0 if kind == "mvn_iso" else 0.3
        x = x + sd * np.random.default_rng(seed).normal(size=x.shape)
    return x.reshape((jt.dim,) + shape).astype(np.float32)


def _hold_pt(monkeypatch, kind, d, prop="Normal", T=3, C=4, S=4,
             lp_atol=1e-4):
    """The plain fused PT version against ``_pt_body_fn`` on shared draws
    (T rungs, C replicas, S steps, burn-in 1, a swap every 2 steps, per-rung
    scale multipliers under Laplace and UniformRadius): counts exact,
    floats to rtol 1e-5 (lp with ``lp_atol`` beside it)."""
    jt, pt, var = _pair(kind, d)
    rng = np.random.default_rng(zlib.crc32(f"{kind}{d}{prop}".encode()))
    betas = np.geomspace(1.0, 0.7, T).astype(np.float32)
    x0 = _start(kind, jt, (T, C), 3)
    acc0 = rng.integers(0, 50, (T, C)).astype(np.int32)
    swapacc0 = rng.integers(0, 50, C).astype(np.int32)
    bj0 = rng.random(C).astype(np.float32) * 3
    cj0 = rng.random(C).astype(np.float32) * 7
    if prop == "Normal":
        p, mult = None, None
        scales = f32_sigmas(var, betas)
    else:
        p = (LaplaceProposal.create(d, np.linspace(0.5, 1.5, d) * var,
                                    device=CPU) if prop == "Laplace" else
             UniformRadiusProposal.create(d, 2.5, device=CPU))
        mult = np.linspace(1.0, 1.5, T).astype(np.float32)
        scales = rung_scales(p, None, torch.from_numpy(betas),
                             torch.from_numpy(mult))[1].numpy()
    dr = make_proposal_draws(11, prop, S, T, d, C)
    ref = run_jax_body(monkeypatch, jt, x0, betas, scales, dr, 0, 1, 2,
                       acc0, swapacc0, bj0, cj0, kind=prop)
    state = pt_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, swap_attempt_count=0, swap_accept_count=swapacc0,
        sum_beta_sq_jump=bj0, sum_sq_jump_cold=cj0, step=0), device=CPU)
    res = run_pt_fused(pt, 0, betas, base_variance=var if p is None else None,
                       proposal=p, scale_multipliers=mult, num_chains=C,
                       num_iterations=S, burn_in=1, swap_every=2,
                       resume_state=state, device=CPU,
                       draws=tuple(torch.from_numpy(a) for a in dr))
    st = res.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2])
    np.testing.assert_array_equal(st.swap_accept_count.numpy(), ref[3])
    np.testing.assert_allclose(st.x.numpy(), ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL,
                               atol=lp_atol)
    np.testing.assert_allclose(st.sum_beta_sq_jump.numpy(), ref[4],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()


@pytest.mark.parametrize("kind", list(_kinds(300)))
def test_fused_pt_plain_matches_pallas_body_at_d300(monkeypatch, kind):
    """Every kind at d = 300 (the 512 bucket): the plain fused PT version,
    which the ``.w512`` kernels are held against, step for step against
    ``pallas_pt.py::_pt_body_fn`` (counts exact, floats to rtol 1e-5)."""
    _hold_pt(monkeypatch, kind, 300)


@pytest.mark.parametrize("prop", list(_build.PROPOSALS))
def test_fused_pt_plain_proposals_match_pallas_body_at_d600(monkeypatch,
                                                           prop):
    """Each proposal at d = 600 (the 1024 bucket) on the iso MVN, with the
    Pallas kernel's own increments (``_laplace`` with per-rung (T, d)
    scales, ``_uniform_ball`` with per-rung radii)."""
    _hold_pt(monkeypatch, "mvn_iso", 600, prop)


@pytest.mark.parametrize("kind", ["mvn_iso", "rosenbrock", "iid_gamma"])
def test_fused_pt_plain_matches_pallas_body_at_d1000(monkeypatch, kind):
    """The iso MVN, FullRosenbrock and IIDGamma at d = 1000."""
    _hold_pt(monkeypatch, kind, 1000, T=2, C=3, S=3)


@pytest.mark.parametrize("kind", ["mvn_iso", "rosenbrock"])
def test_fused_rwm_plain_matches_pallas_body_at_d1000(monkeypatch, kind):
    """The plain fused RWM version at d = 1000 against the Pallas body at
    T = 1 with no swaps, resumed after its burn-in."""
    jt, pt, var = _pair(kind, 1000)
    C, S = 4, 5
    rng = np.random.default_rng(9)
    x0 = _start(kind, jt, (C,), 4)
    acc0 = rng.integers(0, 20, C).astype(np.int32)
    jump0 = (rng.random(C) * 5).astype(np.float32)
    normals, u_mh, _ = make_draws(17, S, 1, 1000, C)
    betas = np.ones(1, np.float32)
    ref = run_jax_body(monkeypatch, jt, x0[:, None], betas,
                       f32_sigmas(var, betas), (normals, u_mh, u_mh[:, :0]),
                       0, 2, 10 ** 6, acc0[None], None, None, jump0)
    state = rwm_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, sum_sq_jump=jump0, step=0), device=CPU)
    r = run_rwm_fused(pt, 0, base_variance=var, num_chains=C,
                      num_iterations=S, burn_in=2, resume_state=state,
                      device=CPU, draws=(torch.from_numpy(normals[:, 0]),
                                         torch.from_numpy(u_mh[:, 0])))
    st = r.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2][0])
    np.testing.assert_allclose(st.x.numpy(), ref[0][:, 0], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1][0], rtol=RTOL,
                               atol=1e-4)
    np.testing.assert_allclose(st.sum_sq_jump.numpy(), ref[5], rtol=RTOL,
                               atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()


def test_harness_rwm_rate_at_d500_matches_jax():
    """``MCMCSimulation`` RWM on the iso MVN at d = 500 (the fused path's
    plain version on the CPU) against the JAX harness (its scan engine on
    the CPU): per-chain acceptance and ESJD within 5 Monte-Carlo standard
    errors at the optimal scale 2.38^2 / d."""
    kw = dict(dim=500, sigma=2.38 ** 2 / 500, num_iterations=200,
              algorithm="RWM", target_dist="MultivariateNormal", seed=5,
              burn_in=50, num_chains=64, record_chain=False)
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


@pytest.mark.parametrize("kind", ["mvn_iso", "scaled_mvn"])
def test_device_ladder_plain_equals_host_loop_at_d300(kind):
    """The ladder kernel's plain version (the ``.d512`` library's) against
    the host loop at d = 300, one seed, one probe stream: the same
    decisions, the same ladder."""
    name = {"mvn_iso": "MultivariateNormal",
            "scaled_mvn": "MultivariateNormalScaled"}
    tg = tget(name[kind], 300, device=CPU)
    assert _build.ladder_lib(kind, tg.dim) == f"ladder_build.{kind}.d512"
    opts = dict(N_samples_swap_est=300, tolerance=0.05,
                max_pn_adjustment_steps=20, seed=5)
    host = construct_iterative_ladder(tg, **opts)
    dev = L._construct_iterative_ladder_device_plain(
        tg, max_T=L.EAGER_MAX_RUNGS + 1, **opts)
    assert len(dev.betas) == len(host) > 5
    np.testing.assert_allclose(dev.betas, host, rtol=1e-5)
    assert dev.betas[0] == 1.0 and dev.betas[-1] == 0.01


def test_tempered_funnel_overflows_both_device_ladders_at_d300():
    """NealFunnel's tempered v has mean (1 - beta)(d - 1) sigma_v^2 /
    (2 beta): at d = 300, sigma_v^2 = 9 and the search's first probe
    (beta* = 1 / (1 + e^0.5)) ~2200, where exp(v) overflows float32, so
    every swap estimate is NaN, the rung's search runs to its cap and JAX's
    one-program builder and the ladder kernel's plain version alike end
    the ladder at [1, beta_min].  At sigma_v^2 = 0.01 (~2.5) the estimates
    are finite: ``chip_smoke.py`` phase 20e holds the kernel there."""
    opts = dict(N_samples_swap_est=256, tolerance=0.05,
                max_pn_adjustment_steps=5, seed=1)
    want = [1.0, pytest.approx(0.01)]
    assert list(jdevice(jget("NealFunnel", 300), **opts)) == want
    plain = L._construct_iterative_ladder_device_plain(
        tget("NealFunnel", 300, device=CPU), max_T=L.EAGER_MAX_RUNGS + 1,
        **opts)
    assert plain.betas == want and plain.probes == 5
    assert all(math.isnan(a) for a in plain.a_hats)
    narrow = L._construct_iterative_ladder_device_plain(
        tget("NealFunnel", 300, sigma_v_sq=0.01, device=CPU),
        max_T=L.EAGER_MAX_RUNGS + 1, beta_min=0.3, **opts)
    assert narrow.probes >= 5
    assert all(math.isfinite(a) for a in narrow.a_hats)


def test_super_funnel_at_d406_matches_jax_and_takes_a_fixed_team_build():
    """SuperFunnel at J = 100, K = 3, n = 20 (d = 406, the 512 bucket): the
    dataset bit for bit and the log-density to rtol 1e-5 against JAX's;
    its dataset (8,412 padded words) fits the team kernels' shared memory,
    so both kernels route to the build with its shape fixed."""
    jt = JSuperFunnel.create_synthetic(100, 3, 20, seed=42)
    pt = SuperFunnel.create_synthetic(100, 3, 20, seed=42, device=CPU)
    assert pt.dim == jt.dim == 406
    np.testing.assert_array_equal(pt.X_cols.numpy(), np.asarray(jt.X_cols))
    np.testing.assert_array_equal(pt.Y.numpy(), np.asarray(jt.Y))
    x = np.random.default_rng(2).normal(size=(406, 16)).astype(np.float32)
    x[-2:] = np.abs(x[-2:]) + np.float32(0.1)
    np.testing.assert_allclose(
        pt.log_density_td(torch.from_numpy(x)).numpy(),
        np.asarray(jt.log_density_td(jnp.asarray(x))), rtol=1e-5)
    assert _build.sf_team_words(100, 3, 20) == 8412
    for v, u in (("fused_pt_lax_erfinv", 2), ("fused_rwm_lax_erfinv", 4)):
        lib, kind, words = _build.route(v, pt)
        assert lib == f"{v}.super_funnel.j100k3n20u{u}.w512"
        assert words.numel() == 8412 and kind == "super_funnel"
        assert _build._parts(lib)[4] == 512
        assert _build.route(v, pt, specialize=False)[0] == \
            f"{v}.super_funnel.w512"
    for g in _build.WARP_TEAMS[512]:
        assert _build.sf_team_dmax(406, g) <= 512
