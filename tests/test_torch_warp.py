"""The fused kernels above 64 dimensions (a team of G lanes a replica,
``csrc/fused_pt_warp.cu``, ``csrc/fused_rwm_warp.cu``): the lane layout of
``csrc/warp.cuh`` through its Python mirror in ``kernels/_build.py``, the
warp buckets, library names and launch geometry, and the plain versions
the kernels are held against at d = 100, step for step against the JAX
package's Pallas body on shared draws for every target kind, plus the
harness and the RWM study CLI at d = 100 on the CPU.  No card needed: the
card tests (``tests/test_torch_cuda.py``) hold the kernels against these
plain versions."""
import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import f32_sigmas, make_draws, run_jax_body
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.api import MCMCSimulation
from rwm_pt_tpu_torch.cli import experiment_rwm
from rwm_pt_tpu_torch.convert import (pt_state_from_numpy,
                                      rwm_state_from_numpy, target_from_numpy)
from rwm_pt_tpu_torch.kernels import _build, draws, run_pt_fused, run_rwm_fused
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
D = 100


def _spd(d, seed=5):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return (a @ a.T / d + np.eye(d)).astype(np.float32)


# kernel kind -> (registry name, registry kwargs at d = 100, Normal variance
# times d: chip_smoke.py's KINDS)
KINDS_100 = {
    "rosenbrock": ("FullRosenbrock", {}, 0.25),
    "mvn_iso": ("MultivariateNormal", {}, 2.38 ** 2),
    "mvn_full": ("MultivariateNormal", {"cov": _spd(D)}, 1.5 * 2.38 ** 2),
    "scaled_mvn": ("MultivariateNormalScaled", {}, 0.25 * 2.38 ** 2),
    "three_mixture": ("ThreeMixtureScaled", {}, 2.38 ** 2),
    "rough_carpet": ("RoughCarpetScaled", {}, 0.25 * 2.38 ** 2),
    "even_rosenbrock": ("EvenRosenbrock", {}, 0.5 ** 2),
    "hybrid_rosenbrock": ("HybridRosenbrock", {"n1": 4, "n2": 33}, 0.03),
    "hypercube": ("Hypercube", {}, 2.38 ** 2 / 3),
    "iid_gamma": ("IIDGamma", {}, 18 * 2.38 ** 2),
    "iid_beta": ("IIDBeta", {}, 0.04 * 2.38 ** 2),
    "neal_funnel": ("NealFunnel", {}, 2.38 ** 2),
}


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("team", _build.TEAMS)
@pytest.mark.parametrize("d", [65, 100, 123, 124, 125, 200, 251, 252])
def test_every_slot_is_computed_by_one_lane(d, team):
    """Slots 0..d+3 (the increments, the MH, swap and radius uniforms and
    Box-Muller's odd-d angle) each come from exactly one lane of a team of
    G lanes, the lane ``warp_slot_owner`` names, in a trip of its block
    loop that the bucket has at that G."""
    dmax = _build.warp_bucket(d)
    blocks = _build.warp_blocks(d, dmax, team)
    assert set(blocks) == set(range(team))
    nq = _build.team_quads(dmax, team)
    assert nq == dmax // (4 * team)
    seen = {}
    for lane, qs in blocks.items():
        for q in qs:
            assert q % team == lane
            for j in range(4 * q, 4 * q + 4):
                assert j not in seen
                seen[j] = lane
    assert set(range(d + 4)) <= set(seen)
    assert max(seen) < dmax
    for j in range(d + 4):
        lane, quad, word = _build.warp_slot_owner(j, team)
        assert seen[j] == lane and 4 * (team * quad + lane) + word == j
        assert lane < team and quad < nq


@pytest.mark.parametrize("team", _build.TEAMS)
def test_every_dimension_of_the_warp_buckets(team):
    """For every d in 65..252 and every team size G, the blocks computed
    are exactly those that hold a slot of 0..d+3, no lane computes more
    than the bucket's quads a lane, and the lanes' counts differ by at most
    one (the rolled loop's trips, ceil(blocks / G))."""
    for d in range(65, 253):
        dmax = _build.warp_bucket(d)
        blocks = _build.warp_blocks(d, dmax, team)
        got = sorted(q for qs in blocks.values() for q in qs)
        assert got == list(range((d + 3) // 4 + 1)), d
        counts = [len(qs) for qs in blocks.values()]
        assert max(counts) <= _build.team_quads(dmax, team)
        assert max(counts) - min(counts) <= 1
        assert max(counts) == -(-len(got) // team) == \
            _build.block_trips(d, team)


@pytest.mark.parametrize("team", _build.TEAMS)
@pytest.mark.parametrize("d", [65, 100, 125, 252])
def test_box_muller_partner_lanes(d, team):
    """Pair k takes u1 from slot k and u2 from ``draws.bm_slots``' slot;
    the team lane of coordinate k computes it, and each coordinate in
    [h, d) receives exactly one sine, from pair i - h, all inside the
    team."""
    h = (d + 1) // 2
    s1, s2 = draws.bm_slots(d)
    sines = {}
    for k in range(h):
        own, u2_lane, sine_lane = _build.bm_lanes(k, d, team)
        assert own == _build.warp_slot_owner(int(s1[k]), team)[0] \
            == (k // 4) % team
        assert u2_lane == _build.warp_slot_owner(int(s2[k]), team)[0]
        assert 0 <= own < team and 0 <= u2_lane < team
        if k + h < d:
            assert sine_lane == _build.warp_slot_owner(k + h, team)[0]
            assert 0 <= sine_lane < team
            sines[k + h] = k
        else:
            assert sine_lane == -1 and d % 2 and int(s2[k]) == d + 3
    assert sorted(sines) == list(range(h, d))


@pytest.mark.parametrize("team", _build.TEAMS)
def test_box_muller_partners_stay_in_the_team_at_every_d(team):
    """For every d in 65..252: each pair's u2 slot and sine coordinate are
    owned by a lane of the same team of G lanes (csrc/warp.cuh computes the
    pair in the lane of coordinate k, which alone reads slot h + k and
    writes the sine over it)."""
    for d in range(65, 253):
        h = (d + 1) // 2
        lanes = [_build.bm_lanes(k, d, team) for k in range(h)]
        assert all(0 <= a < team and 0 <= b < team and -1 <= c < team
                   for a, b, c in lanes), d
        assert sum(c >= 0 for _, _, c in lanes) == d - h


@pytest.mark.parametrize("dmax,team,pitch", [
    (128, 4, 132), (128, 8, 136), (128, 16, 144), (128, 32, 128),
    (256, 8, 264), (256, 16, 272), (256, 32, 256)])
def test_team_rows_start_on_distinct_banks(dmax, team, pitch):
    """A team's state and scratch rows are ``team_pitch`` words: the
    bucket, plus G below G = 32, so that the 32 / G teams of a warp start
    on distinct banks (a word every lane reads, as the in-order sums read,
    is conflict-free)."""
    assert _build.team_pitch(dmax, team) == pitch
    banks = {(j * pitch) % 32 for j in range(32 // team)}
    assert len(banks) == 32 // team
    with pytest.raises(ValueError, match="no team"):
        _build.team_quads(dmax, 64)


@pytest.mark.parametrize("d,dmax", [(65, 128), (100, 128), (124, 128),
                                    (125, 256), (252, 256)])
def test_warp_bucket_edges(d, dmax):
    assert _build.warp_bucket(d) == dmax
    name = _build.lib_name("fused_pt_lax_erfinv", "mvn_iso", d)
    assert name == f"fused_pt_lax_erfinv.mvn_iso.w{dmax}"
    assert _build.is_warp(name) and _build.launch_key(name) == name
    src, _, _, _, bucket, blocks = _build._parts(name)
    assert (src, bucket, blocks) == ("fused_pt_warp", dmax, 1)
    assert f"-DRWM_PT_DMAX={dmax}" in _build._flags(name)
    teams = _build.library_teams(name)
    assert teams == _build.WARP_TEAMS[dmax] and 32 in teams
    assert f"-DRWM_PT_TEAMS={sum(teams)}" in _build._flags(name)
    assert not any(f.startswith("-DRWM_PT_TEAMS") for f in _build._flags(
        "fused_pt_lax_erfinv.mvn_iso.d64"))


def test_above_252_raises_and_64_stays_a_thread_bucket():
    """The warp buckets end at 4092 dimensions (the 4096-slot bucket):
    4093 raises, naming A15's remainder; 253 takes the 512 bucket."""
    assert _build.MAX_DIM == 4092
    assert _build.warp_bucket(253) == 512
    with pytest.raises(NotImplementedError, match="Queue A item 15"):
        _build.warp_bucket(4093)
    with pytest.raises(NotImplementedError, match="4092"):
        _build.lib_name("fused_rwm", "mvn_iso", 4093)
    assert _build.lib_name("fused_rwm", "mvn_iso", 64) == \
        "fused_rwm.mvn_iso.d64"
    assert _build.launch_key("fused_rwm.mvn_iso.d64") == "fused_rwm.mvn_iso"
    # the warp kernel at a small d, for comparing the layouts
    assert _build.lib_name("fused_rwm", "mvn_iso", 30, warp=True) == \
        "fused_rwm.mvn_iso.w128"
    assert (_build._lib_path("fused_rwm.mvn_iso.w128")
            != _build._lib_path("fused_rwm.mvn_iso.d64"))


def test_launch_counts_by_variant_keep_the_warp_bucket():
    from collections import Counter
    seen = Counter({"fused_pt_lax_erfinv.mvn_iso.w128": 2,
                    "fused_pt_lax_erfinv.iid_beta.w128": 1,
                    "fused_pt_lax_erfinv.mvn_iso": 4,
                    "fused_rwm_bm.mvn_iso.w256": 1, "fused_pt_record": 1})
    assert _build.by_variant(seen) == Counter(
        {"fused_pt_lax_erfinv.w128": 3, "fused_pt_lax_erfinv": 4,
         "fused_rwm_bm.w256": 1, "fused_pt_record": 1})


# ------------------------------------------------------------ geometry
def test_pt_warp_geometry_at_d100():
    """T = 10 rung-warps at 64 registers: 1 replica (10 warps, 3 blocks an
    SM), 2 (20 warps, 1 block) and 3 (30 warps, 1 block) hold 960, 640 and
    960 threads an SM; the largest of the best, 3; its shared memory is 30
    warps' two rows of 128 words, the parameters, the ladder and the
    sweep's words (per slot, pair and replica)."""
    g = _build.pt_warp_geometry(64, 1024, D, 128, 10, 65536, n_params=D + 1)
    assert (g.replicas, g.threads, g.blocks_per_sm) == (3, 960, 1)
    assert g.grid == -(-65536 // 3)
    words = 30 * 256 + 101 + 20 + 60 + 15 + 90 + 3
    assert g.shared_bytes == 4 * words
    # at 40 registers 1 replica holds 4 blocks (1280 threads), 2 replicas
    # two (1280): the larger, 2
    g = _build.pt_warp_geometry(40, 1024, D, 128, 10, 65536, n_params=D + 1)
    assert (g.replicas, g.blocks_per_sm, g.threads) == (2, 2, 640)


@pytest.mark.parametrize("T,replicas", [(1, 32), (10, 3), (11, 2), (16, 2),
                                        (17, 1), (32, 1)])
def test_pt_warp_replicas_within_32_warps(T, replicas):
    g = _build.pt_warp_geometry(64, 1024, D, 128, T, 65536, n_params=D + 1)
    assert g.replicas * T <= 32 and g.threads == 32 * g.replicas * T
    assert g.replicas == replicas


def test_the_256_bucket_takes_16_rungs():
    """The 256 bucket's one-warp-a-state instantiation (G = 32) is bound to
    16 warps a block (at 32 and at 24 it spilled): 16 rungs of one replica
    fit it, 17 do not.  Its libraries' smaller team (G < 32, 512 threads a
    block, no spill in the smoke's phase 2) takes a replica of 32 rungs in
    one block; more run over a cluster of blocks, so PT takes its fit's
    rungs (``_build.rungs_fit``: 256 up to d = 64, the thread kernel's one
    block; 1024 in the 128 bucket, 512 in the 256 one, eight blocks of a
    cluster by their threads, two rows a rung-team there for every kind)
    and the harness refuses one more, naming the layout."""
    g = _build.pt_warp_geometry(96, 512, 200, 256, 16, 1000, n_params=201)
    assert (g.replicas, g.threads, g.team) == (1, 512, 32)
    g = _build.pt_warp_geometry(96, 512, 200, 256, 10, 1000, n_params=201)
    assert (g.replicas, g.threads, g.blocks_per_sm) == (1, 320, 2)
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(96, 512, 200, 256, 17, 1000, n_params=201)
    small = min(_build.WARP_TEAMS[256])
    g = _build.pt_warp_geometry(64, 512, 200, 256, 32, 1000, n_params=201,
                                team=small)
    assert g.threads == small * 32 * g.replicas <= 512
    assert [_build.max_rungs(d) for d in (30, 64, 100, 124, 125, 252)] == \
        [256, 256, 1024, 1024, 512, 512]
    kw = dict(sigma=0.01, num_iterations=2, algorithm="PT",
              target_dist="MultivariateNormal", num_chains=2, device=CPU)
    assert MCMCSimulation(dim=125, beta_ladder=[1.0] * 32,
                          **kw)._fused_refusal() is None
    for T in (17, 31):   # odd ladders: G = 8 with an idle team
        assert MCMCSimulation(dim=200, beta_ladder=[1.0] * T,
                              **kw)._fused_refusal() is None
    for dim, fit in ((125, 512), (124, 1024)):   # the iso MVN's fits
        assert fit == _build.max_rungs(dim, "mvn_iso", "Normal", dim + 1)
        assert MCMCSimulation(dim=dim, beta_ladder=[1.0] * fit,
                              **kw)._fused_refusal() is None
        assert MCMCSimulation(dim=dim, beta_ladder=[1.0] * (fit + 1),
                              **kw)._fused_refusal() == (
            f"at most {fit} rungs "
            f"({_build.rungs_fit(dim, 'mvn_iso', 'Normal', dim + 1).layout})")


def test_pt_warp_geometry_refusals():
    with pytest.raises(ValueError, match="T=33"):
        _build.pt_warp_geometry(64, 1024, D, 128, 33, 100)
    with pytest.raises(ValueError, match="warp bucket"):
        _build.pt_warp_geometry(64, 1024, 125, 128, 10, 100)
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(64, 256, D, 128, 10, 100)   # 320 threads


@pytest.mark.parametrize("C,chains,grid", [(65536, 8, 8192), (1024, 7, 147),
                                           (512, 3, 171), (132, 1, 132),
                                           (1, 1, 1)])
def test_rwm_warp_chains_a_block_cover_the_sms(C, chains, grid):
    """The most chains a block (at most 8) whose grid still gives each of
    the 132 SMs a block."""
    g = _build.rwm_warp_geometry(40, 256, D, 128, C, n_params=D + 1)
    assert (g.replicas, g.threads, g.grid) == (chains, 32 * chains, grid)
    assert g.shared_bytes == 4 * (chains * 256 + D + 1)


def test_large_parameters_stay_out_of_shared_memory():
    """The full-covariance MVN's precision matrix lives in shared memory up
    to 12,288 words (d = 110) and is read through L2 above; Laplace adds
    its scales."""
    small = 1 + 100 + 100 * 100
    big = 1 + 124 + 124 * 124
    assert _build.params_shared_words(small) == small
    assert _build.params_shared_words(big) == 0
    g = _build.rwm_warp_geometry(40, 256, 124, 128, 65536, n_params=big)
    assert g.shared_bytes == 4 * 8 * 256
    lap = _build.rwm_warp_geometry(40, 256, D, 128, 65536, "Laplace",
                                   n_params=D + 1)
    assert lap.shared_bytes == 4 * (8 * 256 + D + 1 + D)
    g = _build.pt_warp_geometry(64, 1024, D, 128, 10, 65536, "Laplace",
                                n_params=D + 1)
    assert g.shared_bytes == 4 * (30 * 256 + 101 + 20 + 60 + 15 + 90 + 3
                                  + 10 * D)


# ------------------------------------------------------------ targets
def _pair(kind):
    """(JAX target, the port's target built from its fields, variance) at
    d = 100."""
    name, kw, var_d = KINDS_100[kind]
    jt = jget(name, D, **kw)
    fields = {f.name: (np.asarray(getattr(jt, f.name))
                       if isinstance(getattr(jt, f.name), jax.Array)
                       else getattr(jt, f.name))
              for f in dataclasses.fields(jt)}
    return (jt, target_from_numpy(type(jt).__name__, fields, device=CPU),
            var_d / D)


@pytest.mark.parametrize("kind", list(KINDS_100))
def test_kernel_target_at_d100(kind):
    jt, pt, _ = _pair(kind)
    assert pt.dim == jt.dim == D
    k, params = _build.kernel_target(pt)
    assert k == kind and params.dtype == torch.float32
    for v in ("fused_pt_lax_erfinv", "fused_rwm_bm"):
        assert _build.lib_name(v, k, pt.dim) == f"{v}.{kind}.w128"


def _start(kind, jt, shape, seed):
    n = int(np.prod(shape))
    x = np.asarray(jt.init_sample(jax.random.key(seed), n)).T
    if kind in ("three_mixture", "rough_carpet", "rosenbrock", "mvn_iso",
                "mvn_full", "scaled_mvn", "even_rosenbrock",
                "hybrid_rosenbrock", "neal_funnel"):
        x = x + 0.3 * np.random.default_rng(seed).normal(size=x.shape)
    return x.reshape((jt.dim,) + shape).astype(np.float32)


@pytest.mark.parametrize("kind", list(KINDS_100))
def test_fused_pt_plain_matches_pallas_body_at_d100(monkeypatch, kind):
    """The plain fused PT version, which the warp kernel is held against,
    step for step against ``pallas_pt.py::_pt_body_fn`` at d = 100 on
    shared draws (C = 8, T = 3, 5 steps): counters exact, floats to rtol
    1e-5."""
    jt, pt, var = _pair(kind)
    T, C, S = 3, 8, 5
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    betas = np.geomspace(1.0, 0.7, T).astype(np.float32)
    x0 = _start(kind, jt, (T, C), 3)
    acc0 = rng.integers(0, 50, (T, C)).astype(np.int32)
    swapacc0 = rng.integers(0, 50, C).astype(np.int32)
    bj0 = rng.random(C).astype(np.float32) * 3
    cj0 = rng.random(C).astype(np.float32) * 7
    dr = make_draws(11, S, T, D, C)
    ref = run_jax_body(monkeypatch, jt, x0, betas, f32_sigmas(var, betas),
                       dr, 0, 1, 2, acc0, swapacc0, bj0, cj0)
    state = pt_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, swap_attempt_count=0, swap_accept_count=swapacc0,
        sum_beta_sq_jump=bj0, sum_sq_jump_cold=cj0, step=0), device=CPU)
    res = run_pt_fused(pt, 0, betas, base_variance=var, num_chains=C,
                       num_iterations=S, burn_in=1, swap_every=2,
                       resume_state=state, device=CPU,
                       draws=tuple(torch.from_numpy(a) for a in dr))
    st = res.state
    np.testing.assert_array_equal(st.accept_count.numpy(), ref[2])
    np.testing.assert_array_equal(st.swap_accept_count.numpy(), ref[3])
    np.testing.assert_allclose(st.x.numpy(), ref[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(st.sum_beta_sq_jump.numpy(), ref[4],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()


@pytest.mark.parametrize("kind", ["rosenbrock", "mvn_iso"])
def test_fused_rwm_plain_matches_pallas_body_at_d100(monkeypatch, kind):
    """The plain fused RWM version at d = 100 against the Pallas body at
    T = 1 with no swaps (as tests/test_torch_rwm.py holds it at d <= 7)."""
    jt, pt, var = _pair(kind)
    C, S = 16, 12
    rng = np.random.default_rng(D)
    x0 = _start(kind, jt, (C,), 4)
    acc0 = rng.integers(0, 20, C).astype(np.int32)
    jump0 = (rng.random(C) * 5).astype(np.float32)
    normals, u_mh, _ = make_draws(17, S, 1, D, C)
    betas = np.ones(1, np.float32)
    ref = run_jax_body(monkeypatch, jt, x0[:, None], betas,
                       f32_sigmas(var, betas), (normals, u_mh, u_mh[:, :0]),
                       0, 3, 10 ** 6, acc0[None], None, None, jump0)
    state = rwm_state_from_numpy(dict(
        x=x0, logp=np.asarray(jt.log_density_td(jnp.asarray(x0))),
        accept_count=acc0, sum_sq_jump=jump0, step=0), device=CPU)
    r = run_rwm_fused(pt, 0, base_variance=var, num_chains=C,
                      num_iterations=S, burn_in=3, resume_state=state,
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


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("algo", ["RWM", "PT"])
def test_harness_takes_the_fused_kernels_at_d100(algo):
    """``engine='auto'`` takes the fused samplers at d = 100, as the JAX
    harness takes its Pallas kernel at any d; above 4092 it names the
    reason (ROADMAP A15's remainder)."""
    kw = dict(sigma=0.05, num_iterations=5, algorithm=algo,
              target_dist="MultivariateNormal", num_chains=4,
              beta_ladder=[1.0, 0.5] if algo == "PT" else None,
              swap_every=2, device=CPU)
    sim = MCMCSimulation(dim=D, **kw)
    assert sim._fused_refusal() is None and sim._use_pallas()
    chain = sim.generate_samples(verbose=False)
    assert sim.engine_used == "pallas" and chain.shape == (5, D)
    big = MCMCSimulation(dim=4093, **kw)
    assert not big._use_pallas()
    assert "Queue A item 15" in big._fused_refusal()


def test_study_cli_at_d100(tmp_path):
    """``experiment_rwm --dim 100`` on the CPU (the plain versions): two
    configs, the JAX study's JSON."""
    data = experiment_rwm.main([
        "--dim", str(D), "--target", "MultivariateNormal", "--num_iters",
        "20", "--burn_in", "5", "--num_configs", "2", "--num_chains", "4",
        "--var_max", "2.4", "--no_plots", "--cpu", "--output_dir",
        str(tmp_path)])
    assert data["dimension"] == D and len(data["acceptance_rates"]) == 2
    accs = np.asarray(data["acceptance_rates"])
    assert ((accs >= 0) & (accs <= 1)).all() and accs[0] > accs[1]
    (f,) = os.listdir(tmp_path)
    with open(tmp_path / f) as fh:
        assert json.load(fh)["dimension"] == D
