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
