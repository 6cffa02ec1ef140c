"""Launch geometry of the fused kernels (``kernels/_build.py``), a pure
function of the kernel's registers and ``maxThreadsPerBlock`` and the
launch's shape: the replicas (chains) a block, the shared memory of the
state slabs and the blocks an SM holds, by the CUDA occupancy calculator's
rules for one H100 SM.  No card needed: the card tests hold the counts
against ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
import pytest

from rwm_pt_tpu_torch.kernels import _build

FLAG = dict(d=30, dmax=32, T=10, C=65536, n_params=31)   # bench.py:63-95


def _flagship(regs=96, max_threads=320, draw="bm", **kw):
    args = dict(FLAG, **kw)
    return _build.pt_block_geometry(regs, max_threads, args["d"],
                                    args["dmax"], args["T"], args["C"],
                                    "Normal", draw, args["n_params"])


def test_flagship_takes_32_replicas_and_two_blocks():
    g = _flagship()
    assert (g.replicas, g.threads, g.grid) == (32, 320, 2048)
    # 320 state rows of 36 words and sine rows of 17, params, ladder,
    # the sweep's words
    words = 320 * (36 + 17) + 31 + 2 * 10 + 2 * 320 + 2 * 32 + 3 * 320 + 32
    assert g.shared_bytes == 4 * words
    assert g.blocks_per_sm == 2
    assert _flagship(draw="icdf").shared_bytes == 4 * (words - 17 * 320)


@pytest.mark.parametrize("regs,blocks", [(40, 3), (64, 3), (72, 2),
                                         (96, 2), (97, 1), (128, 1),
                                         (168, 1), (169, 0)])
def test_blocks_per_sm_follow_the_register_file(regs, blocks):
    """320-thread blocks: registers go to a warp 256 at a time from one
    quarter of the register file (5 warps a quarter at 96 registers, 4 at
    97..104; 10 warps need 3 of some quarter, so above 168 registers not
    even one block fits); three blocks' slabs fill the 228 KB of shared
    memory."""
    shared = _flagship().shared_bytes
    assert _build.blocks_per_sm(regs, 320, shared) == blocks


@pytest.mark.parametrize("regs,T,draw,replicas,blocks", [
    (91, 10, "bm", 32, 2),             # the flagship: 640 threads an SM
    (88, 10, "lax_erfinv", 32, 2),
    (96, 15, "lax_erfinv", 21, 2),     # 320 // T replicas, 630 threads
    (105, 15, "bm", 17, 2),            # not 21: one block, 315 threads
    (105, 11, "bm", 23, 2),
    (97, 10, "bm", 25, 2),             # 500 threads, not 320
    (168, 10, "icdf", 19, 2),          # 380 threads, not 320
    (169, 10, "icdf", 25, 1)])
def test_replicas_a_block_hold_the_most_threads_an_sm(regs, T, draw,
                                                      replicas, blocks):
    """Of the replicas a block that fit, the geometry takes the count whose
    blocks let an SM hold the most threads, the largest count of those:
    where registers allow two blocks of 32 T threads it is 32, and where a
    block of 320 // T replicas would sit alone, smaller blocks two at a
    time hold more."""
    g = _flagship(regs=regs, draw=draw, T=T)
    assert (g.replicas, g.blocks_per_sm) == (replicas, blocks)
    for r in range(1, 320 // T + 1):
        shared = _build.pt_shared_bytes(31, T, 30, r, 32, "Normal", draw)
        assert (_build.blocks_per_sm(regs, r * T, shared) * r * T
                <= g.blocks_per_sm * g.threads)


@pytest.mark.parametrize("threads,regs,shared,blocks", [
    (32, 16, 0, 32),          # the 32-block limit
    (128, 16, 0, 16),         # the 64-warp limit
    (128, 64, 23000, 8),      # registers: 32 warps
    (128, 40, 40000, 5),      # shared memory: 5 x 41 KB
    (1024, 64, 0, 1)])
def test_blocks_per_sm_limits(threads, regs, shared, blocks):
    assert _build.blocks_per_sm(regs, threads, shared) == blocks


def test_fewer_replicas_at_32_rungs_of_64_coordinates():
    """T = 32 at DMAX 64: the 320-thread launch bound leaves at most 10
    replicas a block, and at 120 registers two blocks of 8 (512 threads)
    beat one of 10; without the bound, the 227 KB of a block's shared
    memory would hold 17 replicas' slabs."""
    g = _build.pt_block_geometry(120, 320, 64, 64, 32, 65536, "Normal", "bm",
                                 65)
    assert (g.replicas, g.threads, g.blocks_per_sm) == (8, 256, 2)
    assert g.grid == 8192
    assert g.shared_bytes <= _build.BLOCK_SHARED
    g = _build.pt_block_geometry(64, 1024, 64, 64, 32, 65536, "Normal", "bm",
                                 65)
    assert g.replicas == 17
    assert g.shared_bytes <= _build.BLOCK_SHARED < _build.pt_shared_bytes(
        65, 32, 64, 18, 64, "Normal", "bm")


def test_fewer_replicas_for_a_full_covariance_register_count():
    """A kernel of 252 registers (the full-covariance MVN's with its
    state in registers) allows 256 threads a block: 25 replicas of 10
    rungs."""
    g = _build.pt_block_geometry(252, 256, 30, 32, 10, 65536, "Normal",
                                 "icdf", 1 + 30 + 900)
    assert (g.replicas, g.threads, g.blocks_per_sm) == (25, 250, 1)
    assert g.grid == -(-65536 // 25)


def test_ragged_and_single_replica_grids():
    g = _flagship(C=1000)
    assert g.replicas == 32 and g.grid == 32      # 31 full blocks + 8
    assert _flagship(C=1).grid == 1
    r = _build.rwm_block_geometry(64, 128, 30, 32, 1000, "Normal", "bm", 31)
    assert (r.replicas, r.grid) == (128, 8)       # 7 full blocks + 104
    assert _build.rwm_block_geometry(64, 128, 1, 8, 1).grid == 1


def test_rwm_headline_geometry():
    r = _build.rwm_block_geometry(64, 128, 30, 32, 65536, "Normal", "bm", 31)
    assert (r.replicas, r.threads, r.grid) == (128, 128, 512)
    assert r.shared_bytes == 4 * (128 * (36 + 17) + 31)
    assert r.blocks_per_sm == 8
    lap = _build.rwm_block_geometry(64, 128, 30, 32, 65536, "Laplace", "bm",
                                    31)
    assert lap.shared_bytes == 4 * (128 * 36 + 31 + 30)


def test_laplace_pt_adds_its_scale_table():
    g = _build.pt_block_geometry(96, 320, 30, 32, 10, 65536, "Laplace", "bm",
                                 31)
    assert g.shared_bytes == _flagship(draw="icdf").shared_bytes + 4 * 300


@pytest.mark.parametrize("kw", [
    dict(max_threads=8),                      # 10 rungs need 10 threads
    dict(n_params=60000),                     # parameters fill the block
])
def test_nothing_fits_raises(kw):
    regs = 96
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_block_geometry(
            regs, kw.get("max_threads", 320), 30, 32, 10, 65536, "Normal",
            "bm", kw.get("n_params", 31))
    if "n_params" in kw:
        with pytest.raises(ValueError, match="does not fit a block"):
            _build.rwm_block_geometry(regs, 128, 30, 32, 65536, "Normal",
                                      "bm", kw["n_params"])


@pytest.mark.parametrize("d,dmax", [(33, 32), (0, 8)])
def test_dimension_outside_the_bucket_raises(d, dmax):
    with pytest.raises(ValueError, match="register bucket"):
        _build.pt_block_geometry(96, 320, d, dmax, 10, 100)
    with pytest.raises(ValueError, match="register bucket"):
        _build.rwm_block_geometry(64, 128, d, dmax, 100)


@pytest.mark.parametrize("dmax", _build.BUCKETS)
def test_rows_are_conflict_free(dmax):
    """A state row is 4 x an odd number of words, so the 16-byte accesses
    of 8 consecutive threads (a quarter-warp's phase) start on 8 distinct
    4-bank groups; a sine row is odd, so 32 threads' words sit in 32
    distinct banks."""
    pitch = _build.row_words(dmax)
    sines = _build.row_words(dmax, draw="bm") - pitch
    assert pitch % 4 == 0 and (pitch // 4) % 2 == 1
    assert len({(t * pitch // 4) % 8 for t in range(8)}) == 8
    assert sines % 2 == 1 and len({t * sines % 32 for t in range(32)}) == 32
    assert _build.row_words(dmax, "Laplace", "bm") == pitch


def test_min_blocks_and_library_flags():
    """The launch bound's minimum blocks ride in the build flags (and so in
    the library's hash)."""
    blocks = _build.min_blocks("fused_pt", "rosenbrock", 32)
    assert (f"-DRWM_PT_MINBLOCKS={blocks}"
            in _build._flags("fused_pt_bm.rosenbrock.d32"))
    assert "-DRWM_PT_MINBLOCKS=1" in _build._flags("fused_pt.rosenbrock.d64")
    assert (_build._lib_path("fused_pt.mvn_full.d32")
            != _build._lib_path("fused_pt.mvn_full.d16"))
    assert _build._parts("fused_rwm.mvn_iso.d8")[5] == _build.min_blocks(
        "fused_rwm", "mvn_iso", 8)
    with pytest.raises(ValueError):
        _build._parts("fused_pt_bm.rosenbrock.d32.b3")   # no fifth part


@pytest.mark.parametrize("name,blocks", [
    ("fused_pt_lax_erfinv.rosenbrock.d32", 2),   # the flagship: 20 warps
    ("fused_pt_bm.rosenbrock.d16", 2),
    ("fused_rwm_lax_erfinv.rosenbrock.d32", 1),  # RWM: no cap that binds
    ("fused_pt.rosenbrock.d64", 1),              # the 64 bucket
    ("fused_pt_icdf_fastlog.mvn_full.d32", 0),   # its quadratic form spills
    ("fused_pt_bm.mvn_full.d16", 1),             # under any lower cap
    ("fused_rwm.mvn_full.d32", 1),
    ("fused_pt_lax_erfinv.hypercube.d32", 1),
    ("fused_pt_lax_erfinv.hypercube.d16", 2)])
def test_a_library_takes_the_stated_blocks(name, blocks):
    """The blocks an SM each library is built for come from a stated table,
    not from its build: the source's cap, one block at the 64 bucket, and
    the few PT libraries whose capped build spills held to fewer."""
    assert _build._parts(name)[5] == blocks
    assert f"-DRWM_PT_MINBLOCKS={blocks}" in _build._flags(name)


# ------------------------------------------- teams of the warp kernels
# the (warp bucket, team size) instantiations of the warp libraries
INSTANTIATED = [(dmax, g) for dmax, teams in _build.WARP_TEAMS.items()
                for g in teams]


@pytest.mark.parametrize("dmax,team", INSTANTIATED)
@pytest.mark.parametrize("T", [1, 3, 7, 10, 16, 17, 31, 32])
def test_pt_team_blocks_are_whole_warps(dmax, team, T):
    """A warp PT block of R replicas x T rung-teams of G lanes is R T G
    threads rounded up to whole warps (the teams of a warp never straddle
    two blocks; an odd T that fits no whole-warp block takes idle teams)
    within the instantiation's launch bound; its shared memory is the
    teams' rows of ``team_pitch`` words, the idle ones' too, and the
    sweep's words.  Up to d = 252 only G = 32 in the 256 bucket (16 warps)
    refuses a replica of more than 16 rungs; above it G = 32 (16 warps)
    does too, and a replica whose rows exceed a block's shared memory is
    refused (the 1024 bucket's 4 KB rows: more than 27 rungs at G = 16;
    the 2048 and 4096 buckets' 8 and 16 KB rows: more than 13 and 6 rungs
    at G = 32, and at G = 64 and 128 more than their 640 threads take,
    ten and five rungs).  A wide team's block starts with its teams'
    exchange words."""
    d = dmax - 28
    cap = _build.pt_team_threads(dmax, team)
    rows = _build.pt_warp_shared_bytes(d + 1, T, d, 1, dmax, team=team)
    if T * team > cap or rows > _build.BLOCK_SHARED:
        assert ((dmax, team) == (256, 32) and T > 16) or (
            dmax in (512, 1024) and (team == 32 and T > 16 or T > 27)) or (
            dmax > 1024 and T > {2048: 13, 4096: 6}[dmax]) or (
            team > 32 and T * team > _build.PT_WIDE_THREADS)
        with pytest.raises(ValueError, match="does not fit a block"):
            _build.pt_warp_geometry(64, cap, d, dmax, T, 65536,
                                    n_params=d + 1, team=team)
        return
    g = _build.pt_warp_geometry(64, cap, d, dmax, T, 65536, n_params=d + 1,
                                team=team)
    live = team * g.replicas * T
    assert g.team == team and g.threads % 32 == 0 and g.threads <= cap
    assert g.threads == _build.pt_block_threads(g.replicas, T, team)
    assert live <= g.threads < live + 32
    if any(R * T * team % 32 == 0 and R * T * team <= cap
           for R in range(1, 33)):
        assert g.threads == live   # padded only where no whole warp fits
    pitch = _build.team_pitch(dmax, team)
    words = ((g.threads // team * _build.WIDE_WORDS if team > 32 else 0)
             + g.threads // team * 2 * pitch + d + 1 + 2 * T
             + 2 * T * g.replicas + 5 * g.replicas + 3 * T * g.replicas
             + g.replicas)
    assert g.shared_bytes == 4 * words


@pytest.mark.parametrize("T,replicas,threads", [(17, 3, 416), (31, 1, 256),
                                                (32, 1, 256)])
def test_the_256_bucket_fits_32_rungs_at_8_lanes(T, replicas, threads):
    """d = 200 (the 256 bucket, G = 8 and 32): more than 16 rungs take the
    G = 8 instantiation (512 threads a block), odd ladders with idle teams
    (T = 17: 3 replicas, 51 teams and one idle, 416 threads; T = 31: one
    replica and one idle team); one warp a state would need more than 16
    warps and is refused, so ``launch_geometry`` takes G = 8 at any grid
    and the harness runs every ladder up to 32 rungs there."""
    g = _build.pt_warp_geometry(64, 512, 200, 256, T, 65536, n_params=201,
                                team=8)
    assert (g.replicas, g.threads, g.team) == (replicas, threads, 8)
    with pytest.raises(ValueError, match="does not fit a block"):
        _build.pt_warp_geometry(64, 512, 200, 256, T, 65536, n_params=201,
                                team=32)
    for C in (1, 512, 65536):
        geos = {8: _build.pt_warp_geometry(64, 512, 200, 256, T, C,
                                           n_params=201, team=8)}
        assert _build.choose_team(geos, 200).team == 8
    # more rungs run over a cluster of such blocks
    assert _build.max_rungs(200) == 8 * _build.pt_cluster_geometry(
        64, 512, 200, 256, _build.max_rungs(200), 1, n_params=12288, team=8,
        rows=2).slots


def test_pt_team_geometry_at_the_main_shape():
    """d = 100, T = 10, 65,536 replicas.  Teams of 4 lanes at 64
    registers: R a multiple of 4 (R T G = 40 R threads, whole warps) up to
    the 512-thread launch bound.  Shared memory sets the blocks an SM
    holds: R = 4 (160 threads, 44 kB) 5 blocks, 800 threads; R = 8 (320,
    87 kB) 2, 640; R = 12 (480, 130 kB) 1, 480; so R = 4.  One warp a
    state (G = 32): R = 3, 30 warps, as before."""
    g = _build.pt_warp_geometry(64, 512, 100, 128, 10, 65536, n_params=101,
                                team=4)
    assert (g.replicas, g.threads, g.blocks_per_sm, g.team) == (4, 160, 5, 4)
    assert g.grid == 65536 // 4
    assert _build.fills(g)
    g32 = _build.pt_warp_geometry(64, 1024, 100, 128, 10, 65536,
                                  n_params=101)
    assert (g32.replicas, g32.threads, g32.team) == (3, 960, 32)


def test_team_rows_of_the_terms_kinds():
    """The IID kinds, SuperFunnel (its groups' likelihoods) and the
    full-covariance MVN keep a third row a team (their terms); the other
    kinds two."""
    assert [_build.team_rows(k) for k in _build.TARGET_KINDS].count(3) == 4
    assert _build.team_rows("super_funnel") == 3
    two = _build.rwm_warp_shared_bytes(101, 100, 8, 128, team=8)
    three = _build.rwm_warp_shared_bytes(101, 100, 8, 128, team=8,
                                         kind="iid_gamma")
    assert three - two == 4 * 8 * _build.team_pitch(128, 8)


@pytest.mark.parametrize("d,dmax,team,chains,grid", [
    (100, 128, 4, 8, 64), (100, 128, 32, 3, 171), (200, 256, 8, 4, 128),
    (200, 256, 32, 3, 171)])
def test_rwm_team_geometry_at_the_campaigns(d, dmax, team, chains, grid):
    """The reference's campaigns, 512 chains: at every instantiated team
    size the chains a block shrink to whole warps until the grid gives
    each SM a block (G = 4: eight chains, one warp, 64 blocks, the fewest;
    G = 8: four, 128 blocks), and no grid fills the card."""
    g = _build.rwm_warp_geometry(56, 256, d, dmax, 512, n_params=d + 1,
                                 team=team)
    assert (g.replicas, g.threads, g.grid) == (chains, team * chains, grid)
    assert g.threads % 32 == 0 and not _build.fills(g)


def test_rwm_team_geometry_at_the_main_shape():
    """65,536 chains: 256 threads a block at every G (32 chains of 8
    lanes), and the grid fills the card."""
    g = _build.rwm_warp_geometry(56, 256, 100, 128, 65536, n_params=101,
                                 team=8)
    assert (g.replicas, g.threads, g.grid) == (32, 256, 2048)
    assert _build.fills(g)


def test_choose_team_takes_the_smallest_team_that_fills():
    """Of the launches a library offers, the smallest G whose grid fills
    the card; where none fills, the smallest G of the fewest block-loop
    trips a step (d = 100, 26 blocks: G = 32 alone takes one; d = 20, six
    blocks: G = 8 takes one as G = 32 does); none at all raises."""
    main = {g: _build.rwm_warp_geometry(56, 256, 100, 128, 65536,
                                        n_params=101, team=g)
            for g in (4, 8, 32)}
    assert _build.choose_team(main, 100).team == 4
    small = {g: _build.rwm_warp_geometry(56, 256, 100, 128, 512,
                                         n_params=101, team=g)
             for g in (4, 8, 32)}
    assert _build.choose_team(small, 100).team == 32
    study = {g: _build.rwm_warp_geometry(56, 256, 20, 128, 1024,
                                         n_params=21, team=g)
             for g in (4, 8, 32)}
    assert not any(_build.fills(g) for g in study.values())
    assert _build.choose_team(study, 20).team == 8
    assert _build.choose_team({4: study[4], 32: study[32]}, 20).team == 32
    assert [_build.block_trips(100, g) for g in (4, 8, 16, 32)] == \
        [7, 4, 2, 1]
    with pytest.raises(ValueError, match="no team size"):
        _build.choose_team({}, 100)


# (algo, d, replicas or chains, the G measured faster) with each team size
# forced, 2000 steps on FullRosenbrock (scripts/bench_torch_warp.py on an
# H100: the main shapes and GRIDS; RWM's 512 chains: the campaigns' kinds)
MEASURED_GRIDS = [("pt", 100, 512, 32), ("pt", 100, 1024, 32),
                  ("pt", 100, 2048, 4), ("pt", 100, 4096, 4),
                  ("pt", 100, 65536, 4), ("rwm", 100, 512, 32),
                  ("rwm", 100, 2048, 32), ("rwm", 100, 4096, 32),
                  ("rwm", 100, 8192, 32), ("rwm", 100, 16384, 4),
                  ("rwm", 100, 32768, 4), ("rwm", 100, 65536, 4),
                  ("pt", 200, 1024, 8), ("pt", 200, 4096, 8),
                  ("rwm", 200, 4096, 32), ("rwm", 200, 16384, 8),
                  ("pt", 500, 1024, 16), ("pt", 500, 4096, 16),
                  ("pt", 500, 16384, 16), ("pt", 500, 65536, 16),
                  ("pt", 1000, 1024, 32), ("pt", 1000, 4096, 32),
                  ("pt", 1000, 16384, 32), ("pt", 1000, 65536, 32)]
# registers of the FullRosenbrock instantiations, as ptxas reports them
ROSENBROCK_REGS = {("pt", 128): {4: 64, 32: 56}, ("pt", 256): {8: 64, 32: 64},
                   ("pt", 512): {16: 64, 32: 71},
                   ("pt", 1024): {16: 64, 32: 71},
                   ("rwm", 128): {4: 56, 32: 56},
                   ("rwm", 256): {8: 56, 32: 56}}


@pytest.mark.parametrize("algo,d,C,faster", MEASURED_GRIDS)
def test_choose_team_takes_the_measured_faster_team(algo, d, C, faster):
    """At every grid timed with each team size forced, the rule (the
    smallest G whose grid is half a wave and whose blocks keep 16 warps an
    SM, else the fewest block trips) picks the one that measured faster:
    G = 32 up to 1,024 PT replicas (0.39 of a wave at G = 4) and 8,192 RWM
    chains (0.37), the small team from 2,048 replicas (0.78) and 16,384
    chains (0.65); G = 16 at d = 500 (25 warps an SM) and G = 32 at
    d = 1000, where G = 16's rows leave 10 warps an SM."""
    dmax = _build.warp_bucket(d)
    geos = {}
    for g, regs in ROSENBROCK_REGS[algo, dmax].items():
        if algo == "pt":
            geos[g] = _build.pt_warp_geometry(
                regs, _build.pt_team_threads(dmax, g), d, dmax, 10, C,
                n_params=d + 2, team=g)
        else:
            geos[g] = _build.rwm_warp_geometry(regs, 256, d, dmax, C,
                                               n_params=d + 2, team=g)
    assert _build.choose_team(geos, d).team == faster


def test_launch_geometry_offers_the_library_teams(monkeypatch):
    """``launch_geometry`` asks the library for each team size it holds
    (``kernel_info(team=G)``) and lets ``choose_team`` pick; ``team=``
    forces one it holds, refuses one it does not, and refuses a
    thread-per-replica library."""
    asked = []

    def info(name, d, T=1, R=1, n_params=0, runtime_r=False, team=32):
        asked.append(team)
        return {"registers": 56, "max_threads": 256 if "rwm" in name
                else _build.pt_team_threads(128, team), "local_bytes": 0,
                "shared_bytes": 0, "blocks_per_sm": 1}

    monkeypatch.setattr(_build, "kernel_info", info)
    name = "fused_rwm_lax_erfinv.rosenbrock.w128"
    teams = _build.library_teams(name)
    g = _build.launch_geometry(name, 100, 65536, proposal="Normal",
                               draw="lax_erfinv", n_params=101)
    assert sorted(asked) == sorted(teams) and g.team == min(teams)
    assert _build.launch_geometry(name, 100, 512, n_params=101).team == 32
    assert _build.launch_geometry(name, 100, 65536, n_params=101,
                                  team=32).team == 32
    with pytest.raises(ValueError, match="holds teams"):
        _build.launch_geometry(name, 100, 65536, team=64)
    with pytest.raises(ValueError, match="team= is for the warp"):
        _build.launch_geometry("fused_rwm.rosenbrock.d32", 30, 65536, team=8)
    pt = "fused_pt_lax_erfinv.rosenbrock.w128"
    g = _build.launch_geometry(pt, 100, 65536, T=10, n_params=101)
    assert g.team == min(_build.library_teams(pt)) and g.threads % 32 == 0
