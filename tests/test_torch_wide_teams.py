"""PT's wide teams (``csrc/warp.cuh``: G = 64 and 128 lanes, two and four
warps a state, in the 2048 and 4096 buckets of ``csrc/fused_pt_warp.cu``),
the three-row kinds' terms row in global memory, and the cluster build's
layout, on the CPU: the layout's Python mirror, the geometry, the shared
words against a transcription of the kernel's count, the team rule's
picks and the rungs a launch takes at every bucket edge.  The kernels
themselves are held on the card (``tests/test_torch_cuda.py -k wide_team``,
``chip_smoke.py`` phases 21 and 22)."""
from pathlib import Path

import pytest
import torch

from rwm_pt_tpu_torch.kernels import _build, fused_pt

WIDE = (64, 128)
CSRC = Path(_build.CSRC)


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("dmax,team", [(2048, 64), (4096, 64), (4096, 128)])
def test_every_block_and_pair_has_one_lane_at_every_d(dmax, team):
    """At every d of the bucket (1021..2044, 2045..4092) with teams of two
    or four warps: Philox blocks 0..(d+3)/4 each come from exactly one
    lane, block q from lane q mod G in trip q // G (``warp_slot_owner``);
    the lanes' counts differ by at most one, the most being
    ``block_trips``; every Box-Muller pair's u1, u2 and sine lanes are the
    owners of their slots, each pair computed once."""
    nq = _build.team_quads(dmax, team)
    assert nq * 4 * team == dmax and _build.team_pitch(dmax, team) == dmax
    lo = dmax // 2 - 3
    for d in range(lo, dmax - 3):
        assert _build.warp_bucket(d) == dmax
        blocks = _build.warp_blocks(d, dmax, team)
        n_blocks = (d + 3) // 4 + 1
        flat = sorted(q for qs in blocks.values() for q in qs)
        assert flat == list(range(n_blocks)), d
        assert all(q % team == lane for lane, qs in blocks.items()
                   for q in qs)
        counts = [len(qs) for qs in blocks.values()]
        assert max(counts) - min(counts) <= 1
        assert max(counts) == _build.block_trips(d, team) <= nq
        if d % 97 == 0 or d in (lo, dmax - 4):
            h = (d + 1) // 2
            owners = [_build.bm_lanes(k, d, team) for k in range(h)]
            assert [o[0] for o in owners] == [
                _build.warp_slot_owner(k, team)[0] for k in range(h)]
            assert sum(o[2] >= 0 for o in owners) == d - h
    for j in range(dmax):
        lane, trip, word = _build.warp_slot_owner(j, team)
        assert 4 * (team * trip + lane) + word == j and trip < nq


@pytest.mark.parametrize("dmax", [128, 256, 512, 1024])
def test_wide_teams_only_in_the_widest_buckets(dmax):
    """The wide teams are instantiated in the 2048 and 4096 buckets alone
    (PT's libraries and RWM's; G = 128 in the 4096 bucket only): no
    narrower bucket has a team of 64 or 128 lanes."""
    for g in WIDE:
        with pytest.raises(ValueError, match="no team"):
            _build.team_quads(dmax, g)
    for b, teams in ((2048, (32, 64)), (4096, (32, 64, 128))):
        assert _build.WARP_TEAMS[b] == teams
        assert _build.library_teams(f"fused_pt.mvn_iso.w{b}") == teams
        assert _build.library_teams(f"fused_rwm.mvn_iso.w{b}") == teams
        assert f"-DRWM_PT_TEAMS={sum(teams)}" in _build._flags(
            f"fused_pt_lax_erfinv.iid_gamma.c{b}")
        # no wide team where its registers would spill: SuperFunnel's
        # run-time shape, the one-block Laplace build of a terms-row kind
        for lib in (f"fused_pt_lax_erfinv.super_funnel.w{b}",
                    f"fused_pt_laplace.iid_gamma.w{b}",
                    f"fused_pt_laplace.mvn_full.w{b}"):
            assert _build.library_teams(lib) == (32,), lib
            assert "-DRWM_PT_TEAMS=32" in _build._flags(lib)
        for lib in (f"fused_pt_laplace.iid_gamma.c{b}",
                    f"fused_pt_laplace.mvn_iso.w{b}"):
            assert _build.library_teams(lib) == teams, lib


def test_the_kernel_constants_match_the_mirror():
    """The Python mirror's constants are the sources': a wide team's
    exchange words and the named barriers' cap (``csrc/warp.cuh``), the
    launch bounds of the wide teams and of the cluster build's G = 32
    (``csrc/fused_pt_warp.cu::kBlockThreads``)."""
    warp = (CSRC / "warp.cuh").read_text()
    pt = (CSRC / "fused_pt_warp.cu").read_text()
    assert f"constexpr int kWideWords = {_build.WIDE_WORDS};" in warp
    assert f"constexpr int kMaxWideTeams = {_build.WIDE_MAX_TEAMS};" in warp
    assert f"G > 32 ? {_build.PT_WIDE_THREADS}" in pt
    assert "G == 32 && kCluster ? kClusterThreads" in pt
    rule = pt[pt.index("constexpr int kClusterThreads ="):]
    rule = " ".join(rule[:rule.index(";")].split())
    assert rule.endswith(f"&& kProp == PROPOSAL_NORMAL && kDraw == "
                         f"DRAW_LAX_ERFINV ? {_build.PT_CLUSTER_THREADS} : "
                         f"{_build.PT_TEAM_THREADS}")
    assert set(_build.CLUSTER_THREADS.values()) == {
        _build.PT_CLUSTER_THREADS}
    for kind in _build.TARGET_KINDS:
        named = f"kKind == TARGET_{kind.upper()}" in rule
        for prop in _build.PROPOSALS:
            for draw in _build.DRAWS:
                want = (_build.PT_CLUSTER_THREADS if named and (prop, draw)
                        == ("Normal", "lax_erfinv") else
                        _build.PT_TEAM_THREADS)
                assert _build.pt_team_threads(1024, 32, True, kind, prop,
                                              draw) == want, (kind, draw)
            # every draw's bound, the fit's: the least
            assert _build.pt_team_threads(1024, 32, True, kind, prop) == \
                _build.PT_TEAM_THREADS
    assert "bar.sync %0, %1;" in warp and "mapa.shared::cluster.u32" in pt


# ------------------------------------------------------ the shared words
def _shared_words(team, pitch, n_params, T, d, R, teams, rows, terms,
                  laplace, cluster):
    """``csrc/fused_pt_warp.cu::shared_words`` transcribed: the wide
    teams' words, the rows in shared memory, the staged parameters, the
    ladder, the sweep's words, the terms pool's slot, Laplace's staged
    scales (not in the cluster build)."""
    staged = n_params if n_params <= 12288 else 0
    return ((8 * teams if team > 32 else 0) + teams * rows * pitch + staged
            + 2 * T + 2 * T * R + 5 * R + 3 * T * R + R + int(terms)
            + (T * d if laplace and not cluster else 0))


KIND_WORDS = {"mvn_iso": lambda d: 1 + d, "iid_gamma": lambda d: 3 * d + 8,
              "iid_beta": lambda d: 3 * d + 8,
              "mvn_full": lambda d: 1 + d + d * d,
              "super_funnel": lambda d: 12288, "rosenbrock": lambda d: 3 * d}


@pytest.mark.parametrize("prop", ["Normal", "Laplace"])
@pytest.mark.parametrize("kind", sorted(KIND_WORDS))
@pytest.mark.parametrize("d,dmax", [(300, 512), (1000, 1024), (2000, 2048),
                                    (4000, 4096)])
def test_shared_bytes_are_the_kernels_count(d, dmax, kind, prop):
    """``pt_warp_shared_bytes`` equals the kernel's count for every team
    size of the bucket, one block and a cluster block: two rows in shared
    memory for every kind where the terms row lies in global memory (the
    2048 and 4096 buckets, every cluster build) with the pool's slot
    word; three for the three-row kinds' one-block build up to the 1024
    bucket, with no slot word."""
    n = KIND_WORDS[kind](d)
    for team in _build.WARP_TEAMS[dmax]:
        pitch = _build.team_pitch(dmax, team)
        for slots in (None, 3):
            cluster = slots is not None
            terms = kind in _build.TERMS_ROW_KINDS and (
                cluster or dmax > 1024)
            rows = 3 if kind in _build.TERMS_ROW_KINDS and not terms else 2
            assert _build.pt_team_rows(kind, dmax, cluster) == rows
            assert _build.global_terms(kind, dmax, cluster) == terms
            T = 10
            for R in (1, 2):
                teams = _build.pt_block_threads(R, slots or T, team) // team
                got = _build.pt_warp_shared_bytes(n, T, d, R, dmax, prop,
                                                  team, kind, slots=slots)
                assert got == 4 * _shared_words(
                    team, pitch, n, T, d, R, teams, rows, terms,
                    prop == "Laplace", cluster), (team, slots, R)
    # a fixed SuperFunnel shape (kind None, its two rows given) has no slot
    assert _build.pt_warp_shared_bytes(100, 8, 68, 1, 80, team=4, rows=2) \
        == 4 * _shared_words(4, 84, 100, 8, 68, 1, 8, 2, False, False, False)


# ------------------------------------------------------------ the geometry
def test_wide_team_blocks_and_the_barrier_cap():
    """A wide team's block: whole teams of two or four warps within its
    640-thread bound, at most 15 teams a block (named barriers 1..15);
    d = 2000, T = 10: ten rung-teams of 64 lanes in one block (160 KB of
    rows, 20 warps an SM), 128 lanes (not instantiated there) would need a
    cluster of two blocks of five; d = 4000: two blocks of five at every
    team size, 20 warps an SM at G = 128."""
    assert _build.barriers_fit(960, 64) and not _build.barriers_fit(1024, 64)
    assert _build.barriers_fit(1024, 32) and _build.barriers_fit(1920, 128)
    g = _build.pt_warp_geometry(90, 640, 2000, 2048, 10, 65536, team=64,
                                kind="mvn_iso", n_params=2001)
    assert (g.replicas, g.threads, g.blocks_per_sm, g.team) == (1, 640, 1, 64)
    assert _build.resident_warps(g) == 20
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(90, 640, 2000, 2048, 10, 65536, team=128,
                                kind="mvn_iso")
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(90, 640, 2000, 2048, 11, 65536, team=64,
                                kind="mvn_iso")
    c = _build.pt_cluster_geometry(90, 640, 2000, 2048, 10, 65536, team=128,
                                   kind="mvn_iso", n_params=2001)
    assert (c.cluster, c.slots, c.threads) == (2, 5, 640)
    for team, warps in ((32, 5), (64, 10), (128, 20)):
        c = _build.pt_cluster_geometry(
            90 if team > 32 else 72, _build.pt_team_threads(4096, team, True),
            4000, 4096, 10, 65536, team=team, kind="mvn_iso", n_params=4001)
        assert (c.cluster, c.slots, c.replicas) == (2, 5, 1)
        assert _build.resident_warps(c) == warps, team
    # a cap above the bound does not lift it
    g = _build.pt_warp_geometry(64, 4096, 2100, 4096, 4, 1000, team=128,
                                kind="mvn_iso")
    assert g.threads <= _build.PT_WIDE_THREADS
    assert g.threads // 128 <= _build.WIDE_MAX_TEAMS


def _geos(d, T, C, kind, regs, draw="lax_erfinv"):
    """The launches ``launch_geometry`` weighs at d (every team size of the
    bucket; the cluster build where one block does not hold the ladder),
    for kernels of ``regs[team]`` registers under the Normal proposal and
    ``draw``."""
    dmax = _build.warp_bucket(d)
    n = KIND_WORDS[kind](d)
    out = {}
    for g in _build.WARP_TEAMS[dmax]:
        try:
            out[g] = _build.pt_warp_geometry(
                regs[g], _build.pt_team_threads(dmax, g), d, dmax, T, C,
                n_params=n, team=g, kind=kind)
        except ValueError:
            for k in range(1, _build.CLUSTER_MAX + 1):
                try:
                    out[g] = _build.pt_cluster_geometry(
                        regs[g], _build.pt_team_threads(dmax, g, True), d,
                        dmax, T, C, draw=draw, n_params=n, team=g,
                        kind=kind, cluster=k)
                    break
                except ValueError:
                    pass
    return out


@pytest.mark.parametrize("d,T,kind,team,cluster", [
    (2000, 10, "mvn_iso", 64, 0), (2000, 10, "rosenbrock", 64, 0),
    (2000, 10, "iid_gamma", 64, 0), (4000, 10, "mvn_iso", 128, 2),
    (4000, 10, "rosenbrock", 128, 2), (4000, 10, "iid_gamma", 128, 2),
    (500, 36, "mvn_iso", 16, 2), (1000, 50, "mvn_iso", 32, 2),
    (1000, 50, "iid_gamma", 16, 2)])
def test_choose_team_at_the_main_shapes(d, T, kind, team, cluster):
    """``choose_team`` at 65,536 replicas: the wide teams where G = 32's
    rows leave an SM 5-10 warps (d = 2000: G = 64 in one block, IIDGamma
    too now that its terms row is out of shared memory; d = 4000: G = 128
    over clusters of two blocks), G = 16 over two blocks at d = 500,
    T = 36 as before; at d = 1000, T = 50 G = 32 over two blocks of 25
    rung-teams (25 warps) where its 800-thread bound holds them (the iso
    MVN), else G = 16 over two (13 warps against G = 32's over four)."""
    regs = {16: 80, 32: 72, 64: 90, 128: 90}
    geos = _geos(d, T, 65536, kind, regs)
    g = _build.choose_team(geos, d)
    assert (g.team, g.cluster) == (team, cluster), geos
    assert _build.resident_warps(g) == max(
        _build.resident_warps(o) for o in geos.values())


# ------------------------------------------------------------ the fit
# _build.rungs_fit(d, kind=None, proposal).rungs before the wide teams
# and the terms row's move (the least over the kinds, with the most
# parameter words a block stages), at every bucket edge
PARENT_FIT = {65: (768, 768, 768), 124: (768, 768, 768),
              125: (416, 416, 416), 252: (416, 416, 416),
              253: (209, 209, 209), 508: (209, 209, 209),
              509: (112, 112, 112), 1020: (112, 112, 112),
              1021: (56, 56, 56), 2044: (56, 56, 56),
              2045: (24, 24, 24), 4092: (24, 24, 24)}


@pytest.mark.parametrize("d", sorted(PARENT_FIT))
def test_rungs_fit_falls_nowhere(d):
    """``rungs_fit`` at every bucket edge is no lower than before the wide
    teams, for every proposal and kind (the least over the kinds
    compared), and G = 32 still sets the layout in the widest buckets."""
    for prop, before in zip(_build.PROPOSALS, PARENT_FIT[d]):
        fit = _build.rungs_fit(d, None, prop)
        assert fit.rungs >= before, (prop, fit)
        if d > 1020:
            assert fit.layout.startswith("teams of 32 lanes")
    assert _build.max_rungs(d) >= (64 if d <= 1020 else 56 if d <= 2044
                                   else 24)


# ------------------------------------------------------------ names, pool
def test_measuring_build_and_the_terms_pool_off_the_card():
    """The cluster build's measuring build is ``c<D>s`` (-DRWM_PT_STAMPS),
    a cluster build's alone; a launch without a global terms row needs no
    pool (the two-row kinds, a fixed SuperFunnel shape, the one-block
    build up to the 1024 bucket), so none is made."""
    lib = "fused_pt_lax_erfinv.mvn_iso.w1024"
    s = _build.cluster_lib(lib, stamps=True)
    assert s == "fused_pt_lax_erfinv.mvn_iso.c1024s"
    assert _build.is_stamps(s) and _build.is_cluster(s)
    assert not _build.is_stamps(_build.cluster_lib(lib))
    assert _build.cluster_lib(s) == "fused_pt_lax_erfinv.mvn_iso.c1024"
    assert "-DRWM_PT_STAMPS=1" in _build._flags(s)
    assert "-DRWM_PT_STAMPS=1" not in _build._flags(_build.cluster_lib(lib))
    assert _build._flags(s)[:-1] == _build._flags(_build.cluster_lib(lib))
    with pytest.raises(ValueError):
        _build._parts("fused_pt_lax_erfinv.mvn_iso.w1024s")
    assert fused_pt.SWAP_SPLIT == ("mh", "barrier1", "sweep", "barrier2",
                                   "cold", "barrier3")
    geo = _build.Geometry(1, 640, 0, 1, 10, team=64)
    for name in ("fused_pt_lax_erfinv.mvn_iso.w2048",
                 "fused_pt_lax_erfinv.iid_gamma.w1024",
                 "fused_pt_lax_erfinv.super_funnel.j40k3n20u2.w256"):
        assert _build.terms_pool(name, geo, 1000, 10, 1,
                                 torch.device("cpu")) == (None, None, 0)
    assert _build.global_terms("iid_gamma", 1024, cluster=True)
    assert _build.global_terms("mvn_full", 2048)
    assert not _build.global_terms("neal_funnel", 4096, cluster=True)
