"""PT ladders of more than 32 rungs: the plain fused version against the
Pallas step body and the JAX scan engine at T = 33, 40 and 50, the rule for
the rungs a fused launch takes (``_build.rungs_fit``: the thread kernel's
one block up to d = 64, the team kernels over a thread-block cluster
above), the cluster build's geometry against its kernel's shared-memory
count (``csrc/fused_pt_warp.cu::shared_words``), and the entry points that
take such ladders on the fused path.  No card: the cluster build itself
is held in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 21."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import (f32_sigmas, make_proposal_draws, rate_z,
                                 run_jax_body)
from rwm_pt_tpu.kernels import pt as jpt
from rwm_pt_tpu.kernels import run_pt as jrun_pt
from rwm_pt_tpu.proposals import NormalProposal as JNormalProposal
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.api import MCMCSimulation
from rwm_pt_tpu_torch.convert import pt_state_from_numpy, target_from_numpy
from rwm_pt_tpu_torch.kernels import _build, run_pt, run_pt_fused
from rwm_pt_tpu_torch.kernels.fused_pt import rung_scales
from rwm_pt_tpu_torch.proposals import (LaplaceProposal, NormalProposal,
                                        UniformRadiusProposal)

torch.set_num_threads(1)
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6   # the plain versions' floats against JAX's
# registry name and Normal variance times d of the step-for-step holds
TARGETS = {"rosenbrock": ("FullRosenbrock", 0.25),
           "mvn_iso": ("MultivariateNormal", 2.38 ** 2)}


def _pair(kind, d):
    """(JAX target, the port's target built from its fields, variance)."""
    name, var_d = TARGETS[kind]
    jt = jget(name, d)
    fields = {f.name: (np.asarray(getattr(jt, f.name))
                       if isinstance(getattr(jt, f.name), jax.Array)
                       else getattr(jt, f.name))
              for f in dataclasses.fields(jt)}
    return jt, target_from_numpy(type(jt).__name__, fields,
                                 device=CPU), var_d / d


def _hold(monkeypatch, kind, d, T, prop="Normal", C=3, S=4):
    """The plain fused PT version against ``pallas_pt._pt_body_fn`` driven
    eagerly on shared draws (T rungs, C replicas, S steps, burn-in 1, a
    swap every 2 steps, the sequential sweep, per-rung multipliers under
    Laplace and UniformRadius): counts exact, floats to rtol 1e-5."""
    jt, pt, var = _pair(kind, d)
    rng = np.random.default_rng(zlib.crc32(f"{kind}{d}{T}{prop}".encode()))
    # rungs close enough that the sweep swaps at every d
    betas = np.geomspace(1.0, 0.9, T).astype(np.float32)
    x0 = (np.asarray(jt.init_sample(jax.random.key(3), T * C)).T.reshape(
        d, T, C) + 0.3 * rng.normal(size=(d, T, C))).astype(np.float32)
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
    np.testing.assert_allclose(st.logp.numpy(), ref[1], rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(st.sum_beta_sq_jump.numpy(), ref[4],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(st.sum_sq_jump_cold.numpy(), ref[5],
                               rtol=RTOL, atol=ATOL)
    assert (st.accept_count.numpy() > acc0).any()
    assert (st.swap_accept_count.numpy() > swapacc0).any()


@pytest.mark.parametrize("d", [10, 100, 300])
@pytest.mark.parametrize("T", [33, 50])
def test_plain_matches_pallas_body_beyond_32_rungs(monkeypatch, T, d):
    """FullRosenbrock at d = 10 (the thread kernel), 100 (the 128 bucket)
    and 300 (the 512 bucket, over a cluster on the card) with T = 33 and
    50 rungs, the sequential sweep (the Pallas sweep), step for step
    against ``pallas_pt.py::_pt_body_fn``."""
    _hold(monkeypatch, "rosenbrock", d, T)


@pytest.mark.parametrize("prop", list(_build.PROPOSALS))
def test_plain_proposals_match_pallas_body_at_40_rungs(monkeypatch, prop):
    """Each proposal at d = 100 and T = 40 on the iso MVN, with the Pallas
    kernel's own increments (per-rung (T, d) Laplace scales, per-rung
    radii)."""
    _hold(monkeypatch, "mvn_iso", 100, 40, prop)


@pytest.mark.parametrize("d", [10, 100, 300])
@pytest.mark.parametrize("T", [33, 50])
def test_even_odd_matches_jax_half_sweeps_beyond_32_rungs(monkeypatch, T,
                                                          d):
    """``swap_sweep="even_odd"`` at T = 33 and 50: on the same states and
    per-pair uniforms it equals the JAX scan engine's even then odd
    half-sweep (``kernels/pt.py::_swap_half_sweep``, its uniforms patched
    in).  One step with zero increments and MH uniforms of 1 leaves the
    states in place, then swaps; both parities swap somewhere."""
    C = 64
    jt, pt, _ = _pair("mvn_iso", d)
    rng = np.random.default_rng(T + d)
    x = (rng.normal(size=(d, T, C)) * np.geomspace(1, 1.5, T)[None, :, None]
         ).astype(np.float32)
    betas = np.geomspace(1.0, 0.6, T).astype(np.float32)
    u_sw = rng.random((T - 1, C), dtype=np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(u_sw))
    lp = jt.log_density_td(jnp.asarray(x))
    x1, lp1, a0 = jpt._swap_half_sweep(jnp.asarray(x), lp, jax.random.key(0),
                                       jnp.asarray(betas), 0)
    x2, lp2, a1 = jpt._swap_half_sweep(x1, lp1, jax.random.key(1),
                                       jnp.asarray(betas), 1)
    acc = np.asarray(a0 | a1)
    zero = np.zeros((1, T, d, C), np.float32)
    draws = (zero, np.ones((1, T, C), np.float32), u_sw[None])
    r = run_pt_fused(pt, 0, betas, base_variance=1.0, num_chains=C,
                     num_iterations=1, swap_every=1,
                     init_states=torch.from_numpy(x), swap_sweep="even_odd",
                     device=CPU, draws=tuple(torch.from_numpy(a)
                                             for a in draws))
    np.testing.assert_array_equal(r.state.x.numpy(), np.asarray(x2))
    np.testing.assert_array_equal(r.state.swap_accept_count.numpy(),
                                  acc.sum(0))
    np.testing.assert_allclose(r.state.logp.numpy(), np.asarray(lp2),
                               rtol=RTOL, atol=1e-4)
    assert acc[0::2].any() and acc[1::2].any()


@pytest.mark.parametrize("engine", ["eager", "fused"])
def test_rates_match_jax_scan_at_40_rungs(engine):
    """The port's eager PT engine and its fused plain version against the
    JAX scan engine (even/odd sweep) on the iso MVN at d = 10 and T = 40:
    per-rung MH and swap acceptance within 5 Monte-Carlo standard
    errors."""
    d, C, T = 10, 256, 40
    betas = np.geomspace(1.0, 0.01, T).astype(np.float32)
    var = 2.38 ** 2 / d
    kw = dict(num_chains=C, num_iterations=200, burn_in=50, swap_every=5)
    jr = jrun_pt(jget("MultivariateNormal", d), JNormalProposal.create(d, var),
                 jax.random.key(8), jnp.asarray(betas), **kw)
    pt = _pair("mvn_iso", d)[1]
    r = (run_pt(pt, NormalProposal.create(d, var, device=CPU), 9, betas,
                swap_sweep="even_odd", device=CPU, **kw)
         if engine == "eager" else
         run_pt_fused(pt, 9, betas, base_variance=var, swap_sweep="even_odd",
                      device=CPU, **kw))
    ja = np.asarray(jr.acceptance_rate)
    for t in range(T):
        assert rate_z(r.acceptance_rate[t].numpy(), ja[t]) < 5, t
    assert rate_z(r.swap_acceptance_rate.numpy(),
                  np.asarray(jr.swap_acceptance_rate)) < 5


# ------------------------------------------------------------ the rule
def _params(kind, d):
    """The parameter words of a kind at d (the most a block stages for
    SuperFunnel, whose dataset is free)."""
    if kind == "super_funnel":
        return _build.PARAMS_SHARED_MAX
    return {"mvn_full": 1 + d + d * d, "mvn_iso": 1 + d}.get(kind, 3 * d + 8)


@pytest.mark.parametrize("d", [10, 64, 65, 252, 253, 4092])
def test_max_rungs_is_at_least_64_and_the_layout_fit(d):
    """``max_rungs(d, kind, proposal, n_params)`` is at least 64 for every
    kind and proposal up to d = 1020 and at least 24 up to 4092, and the
    layout's own fit: up to d = 64 the most T
    for which ``pt_block_geometry`` fits one replica in a block of the
    runtime-R instantiation's threads, for every draw (Box-Muller's sine
    row the most); above, the most T for which ``pt_cluster_geometry``
    fits one replica over at most eight blocks at one of the bucket's team
    sizes.  T fits, T + 1 does not; the refusals name the layout."""
    for kind in _build.TARGET_KINDS:
        n = _params(kind, d)
        for prop in _build.PROPOSALS:
            fit = _build.rungs_fit(d, kind, prop, n)
            T = fit.rungs
            assert T == _build.max_rungs(d, kind, prop, n) >= (
                64 if d <= 1020 else 24), (kind, T)
            if d <= _build.BUCKETS[-1]:
                dmax = _build.bucket(d)
                cap = _build.pt_runtime_threads(kind, dmax)

                def fits(T, draw):
                    try:
                        _build.pt_block_geometry(64, cap, d, dmax, T, 1, prop,
                                                 draw, n, kind)
                        return True
                    except ValueError:
                        return False
                assert all(fits(T, dr) for dr in _build.DRAWS)
                assert not fits(T + 1, "bm" if prop != "Laplace" else "icdf")
                assert "one thread a rung" in fit.layout
                continue
            dmax = _build.warp_bucket(d)

            def fits(T):
                out = []
                for g in _build.WARP_TEAMS[dmax]:
                    try:
                        out.append(_build.pt_cluster_geometry(
                            64, _build.pt_team_threads(dmax, g, cluster=True),
                            d, dmax, T, 1, prop, n_params=n, team=g,
                            kind=kind))
                    except ValueError:
                        pass
                return out
            assert fits(T) and not fits(T + 1), (kind, prop, T)
            assert max(g.cluster for g in fits(T)) <= _build.CLUSTER_MAX
            assert "cluster of 8 blocks" in fit.layout
    assert _build.max_rungs(d) == min(
        _build.max_rungs(d, k) for k in _build.TARGET_KINDS)


def _shared_words(pitch, n_params, T, d, R, teams, rows, laplace, cluster,
                  team=32, terms=False):
    """``csrc/fused_pt_warp.cu::shared_words``, as the kernel counts it:
    a wide team's 8 exchange words, the rows, the staged parameters, the
    sweep's words, the terms pool's slot where the terms row lies in
    global memory, Laplace's staged scales."""
    shared = n_params if n_params <= 12288 else 0
    return ((8 * teams if team > 32 else 0) + teams * rows * pitch + shared
            + 2 * T + 2 * T * R + 5 * R + 3 * T * R + R + int(terms)
            + (T * d if laplace and not cluster else 0))


@pytest.mark.parametrize("d,T,team,prop,kind", [
    (500, 50, 16, "Normal", "mvn_iso"), (1000, 50, 32, "Normal", "mvn_iso"),
    (1000, 50, 16, "Normal", "rosenbrock"), (300, 33, 16, "Laplace",
                                             "iid_gamma"),
    (200, 64, 8, "Laplace", "mvn_full"), (1020, 64, 32, "Normal",
                                          "iid_beta")])
def test_cluster_geometry_matches_the_kernel(d, T, team, prop, kind):
    """The cluster build's launch: the smallest k of at most eight blocks
    that one replica fits, ceil(T / k) slots a block, whole warps of
    teams (the ragged slots and the odd T idle teams), the grid a whole
    number of clusters, and the shared bytes the kernel's ``shared_words``
    counts (Laplace's scales through L2, not staged; the three-row kinds'
    terms row in global memory, the block's slot of its pool in shared
    memory); k - 1 blocks do not fit."""
    dmax = _build.warp_bucket(d)
    n = _params(kind, d)
    rows = _build.pt_team_rows(kind, dmax, cluster=True)
    terms = _build.global_terms(kind, dmax, cluster=True)
    assert rows == 2 and terms == (kind in _build.TERMS_ROW_KINDS)
    cap = _build.pt_team_threads(dmax, team, cluster=True)
    C = 1000
    g = _build.pt_cluster_geometry(64, cap, d, dmax, T, C, prop, n_params=n,
                                   team=team, kind=kind)
    k = g.cluster
    assert 1 <= k <= _build.CLUSTER_MAX and g.slots == -(-T // k)
    assert (g.slots - 1) * k < T <= g.slots * k
    assert g.threads % 32 == 0 and g.threads <= cap
    assert g.threads == -(-g.replicas * g.slots * team // 32) * 32
    assert g.grid == -(-C // g.replicas) * k
    pitch = _build.team_pitch(dmax, team)
    assert g.shared_bytes == 4 * _shared_words(
        pitch, n, T, d, g.replicas, g.threads // team, rows,
        prop == "Laplace", True, team, terms) <= _build.BLOCK_SHARED
    if k > 1:
        with pytest.raises(ValueError, match=f"cluster of {k - 1} blocks"):
            _build.pt_cluster_geometry(64, cap, d, dmax, T, C, prop,
                                       n_params=n, team=team, kind=kind,
                                       cluster=k - 1)
    # the one-block build's count (Laplace staged) where one block holds it
    one = _build.pt_warp_shared_bytes(n, T, d, 1, dmax, prop, team, kind)
    assert one == 4 * _shared_words(
        pitch, n, T, d, 1, _build.pt_block_threads(1, T, team) // team,
        _build.pt_team_rows(kind, dmax), prop == "Laplace", False, team,
        _build.global_terms(kind, dmax))


def test_cluster_library_names():
    """The cluster build is PT's team library with its bucket's tag
    ``c<D>``: built with ``-DRWM_PT_CLUSTER``, counted under its own name,
    summed by variant as ``<variant>.c<D>``; RWM and the thread libraries
    have none."""
    lib = _build.lib_name("fused_pt_lax_erfinv", "mvn_iso", 1000)
    c = _build.cluster_lib(lib)
    assert c == "fused_pt_lax_erfinv.mvn_iso.c1024"
    assert _build.is_warp(c) and _build.is_cluster(c)
    assert not _build.is_cluster(lib)
    assert "-DRWM_PT_CLUSTER=1" in _build._flags(c)
    assert "-DRWM_PT_CLUSTER=1" not in _build._flags(lib)
    assert _build._flags(c)[:-1] == _build._flags(lib)
    assert _build._source(c) == "fused_pt_warp"
    assert _build.launch_key(c) == c
    assert _build.by_variant({c: 2}) == {"fused_pt_lax_erfinv.c1024": 2}
    assert _build.library_teams(c) == _build.library_teams(lib)
    for bad in ("fused_rwm.mvn_iso.w1024", "fused_pt.mvn_iso.d32"):
        with pytest.raises(ValueError, match="no cluster build"):
            _build.cluster_lib(bad)
    with pytest.raises(ValueError, match="no library"):
        _build._parts("fused_rwm.mvn_iso.c1024")


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("d", [500, 1000])
def test_harness_iterative_ladder_runs_fused(d):
    """``MCMCSimulation(iterative_temp_spacing=True)`` on the iso MVN down
    to beta_min 0.01 builds a ladder of more than 32 rungs (38 at d = 500,
    50 at d = 1000 with a cheap search: 32 samples a probe, tolerance 0.3,
    swap rate 0.5) and runs it on the fused path (here its plain
    version)."""
    sim = MCMCSimulation(dim=d, sigma=2.38 ** 2 / d, num_iterations=2,
                         algorithm="PT", target_dist="MultivariateNormal",
                         num_chains=2, iterative_temp_spacing=True,
                         beta_min_iterative=0.01, N_samples_swap_est=32,
                         iterative_tolerance=0.3, swap_acceptance_rate=0.5,
                         device=CPU, seed=1)
    assert len(sim.beta_ladder) > 32
    assert abs(sim.beta_ladder[-1] - 0.01) < 1e-6
    assert sim._fused_refusal() is None
    chain = sim.generate_samples(verbose=False)
    assert sim.engine_used == "pallas" and np.isfinite(chain).all()


def test_experiment_pt_takes_33_rungs(tmp_path, monkeypatch):
    """``experiment_pt`` in float32 runs a 33-rung ladder on the fused path
    (its plain version here): the JSON records the ladder's size."""
    from rwm_pt_tpu_torch.cli import experiment_pt as tpt
    monkeypatch.setattr(tpt, "construct_geometric_ladder",
                        lambda: list(np.geomspace(1.0, 0.01, 33)))
    data = tpt.main(["--target", "ThreeMixture", "--dim", "3", "--num_iters",
                     "20", "--burn_in", "10", "--num_configs", "2",
                     "--num_chains", "4", "--seed", "4", "--geom_ladder",
                     "--cpu", "--no_plots", "--output_dir", str(tmp_path)])
    assert data["ladder_sizes"] == [33, 33]


@pytest.mark.parametrize("d,T,steps,ms", [(30, 50, 2000, 188.062),
                                          (100, 50, 2000, 611.203),
                                          (500, 36, 200, 213.263),
                                          (1000, 50, 200, 590.046)])
def test_bound_of_the_long_ladders(d, T, steps, ms):
    """``chip_smoke.py::bound`` at phase 21d's shapes (65,536 replicas of
    the iso MVN): Philox's int32 work grows with the rungs, T / 10 times
    the T = 10 run's at the same steps, and binds."""
    import chip_smoke as cs
    kw = dict(draw="lax_erfinv", n_params=d + 1)
    work = cs.pt_work("mvn_iso", d, T, 65536, steps, 0, 100, **kw)
    ten = cs.pt_work("mvn_iso", d, 10, 65536, steps, 0, 100, **kw)
    assert work[1] * 10 == ten[1] * T
    b_ms, by, limit = cs.bound(*work)
    assert (by, limit) == ("operations", "int32")
    assert b_ms == pytest.approx(ms, rel=1e-5)


def test_launch_geometry_takes_the_cluster_build(monkeypatch):
    """``launch_geometry`` (kernel attributes faked: no card) takes one
    block where a team size's block holds the ladder and the cluster
    build where it does not, at the smallest k the card schedules
    (``clusters`` >= 1 from ``cudaOccupancyMaxActiveClusters``); ``team``
    and ``cluster`` force a team size and a k, as does a cluster library's
    name; RWM and the thread libraries have no cluster build."""
    asked = []

    def info(name, d, T=1, R=1, n_params=0, runtime_r=False, team=32,
             cluster=0):
        asked.append((name, team, cluster))
        dmax = _build._parts(name)[4]
        return {"registers": 64, "local_bytes": 0, "shared_bytes": 0,
                "max_threads": _build.pt_team_threads(dmax, team),
                "blocks_per_sm": 1, "clusters": 0 if cluster == 2 else 30}

    monkeypatch.setattr(_build, "kernel_info", info)
    lib = _build.lib_name("fused_pt_lax_erfinv", "mvn_iso", 1000)
    g = _build.launch_geometry(lib, 1000, 65536, 50, n_params=1001,
                               team=16)
    # G = 16 over 2 blocks fits, but the card holds no such cluster: 3
    assert (g.cluster, g.slots) == (3, 17)
    assert (_build.cluster_lib(lib), 16, 2) in asked
    # G = 32 over 4 blocks keeps 26 warps an SM at 64 registers: taken
    g = _build.launch_geometry(lib, 1000, 65536, 50, n_params=1001)
    assert (g.team, g.cluster, g.slots, _build.resident_warps(g)) == (
        32, 4, 13, 26)
    g = _build.launch_geometry(lib, 1000, 65536, 20, n_params=1001,
                               team=16)
    assert (g.cluster, g.team) == (0, 16)                  # one block
    g = _build.launch_geometry(lib, 1000, 65536, 20, n_params=1001,
                               team=16, cluster=2)        # forced: no check
    assert (g.cluster, g.slots, g.team) == (2, 10, 16)
    g = _build.launch_geometry(_build.cluster_lib(lib), 1000, 65536, 20,
                               n_params=1001, team=32)
    assert g.cluster == 3 and g.team == 32
    with pytest.raises(ValueError, match="cluster build is PT's"):
        _build.launch_geometry(_build.lib_name("fused_rwm", "mvn_iso", 1000),
                               1000, 4096, cluster=2)
    with pytest.raises(ValueError, match="cluster= is for the warp"):
        _build.launch_geometry(_build.lib_name("fused_pt", "mvn_iso", 30),
                               30, 4096, 50, cluster=2)


def test_a_dataset_no_block_holds_has_no_rungs():
    """A SuperFunnel dataset whose words alone fill a block's shared memory
    at d <= 64 (n = 4000 a group: 80,010 words) leaves no rung: the fit is
    0, naming the words, and the harness refuses the fused path; the
    launch's geometry raises naming them too (the card's test)."""
    fit = _build.rungs_fit(26, "super_funnel", "Normal", 80010)
    assert fit == (0, "no rung: 80010 parameter words fill a block's "
                      "shared memory")
    sim = MCMCSimulation(dim=None, sigma=0.01, num_iterations=2,
                         algorithm="PT", target_dist="SuperFunnel",
                         beta_ladder=[1.0, 0.5], num_chains=2, device=CPU,
                         target_kwargs={"n_per_group": 4000})
    assert sim._fused_refusal() == f"at most 0 rungs ({fit.layout})"
