"""The least time the card could take for a fused kernel's work
(``chip_smoke.py``'s ``pt_work``, ``rwm_work`` and ``bound``): the largest
of the float operations at 67 TFLOP/s, Philox's int32 operations at 64 a
clock an SM x 132 SMs x 1.98 GHz and the bytes at 3.35 TB/s, pinned to
the hand counts of the flagship PT run and the RWM headline.  A Philox
block is 10 rounds of 2 high and 2 low products and 2 three-input XORs:
60 operations (the key schedule's additions depend on the key alone and
are done once a thread)."""
import pytest

import chip_smoke as cs

# bench.py:63-95 and scripts/bench_rwm_impl_block.py
D, T, C, STEPS, SWAP_EVERY = 30, 10, 65536, 2000, 100


def test_int32_peak():
    assert cs.PEAK_INT32_OPS == pytest.approx(1.6727e13, rel=1e-4)


def test_philox_block_ops():
    assert cs.PHILOX_BLOCK_OPS == 10 * (2 + 2 + 2)
    assert cs.PROBE_INT_OPS == 15      # two blocks a column of 8 normals


def test_flagship_bound_counts_philox():
    """8 Philox blocks (slots 0..30) a (replica, rung, step), 60 int32
    operations each: 65,536 x 10 x 2000 x 480 = 6.2915e11, 37.6 ms, 3.7
    times the Box-Muller float bound of 10.1 ms."""
    flops, int_ops, nbytes, mufu = cs.pt_work("rosenbrock", D, T, C, STEPS,
                                              0, SWAP_EVERY, draw="bm")
    assert mufu is None
    assert int_ops == 65536 * 10 * 2000 * 8 * 60 == pytest.approx(
        6.2915e11, rel=1e-4)
    assert flops / cs.PEAK_F32_FLOPS * 1e3 == pytest.approx(10.146, rel=1e-3)
    ms, by, limit = cs.bound(flops, int_ops, nbytes)
    assert (by, limit) == ("operations", "int32")
    assert ms == pytest.approx(37.612, rel=1e-3)


def test_rwm_headline_bound_counts_philox():
    flops, int_ops, nbytes, mufu = cs.rwm_work("rosenbrock", D, C, STEPS,
                                               draw="bm")
    assert mufu is None
    assert int_ops == pytest.approx(6.2915e10, rel=1e-4)
    assert flops / cs.PEAK_F32_FLOPS * 1e3 == pytest.approx(1.180, rel=1e-3)
    ms, by, limit = cs.bound(flops, int_ops, nbytes)
    assert (by, limit) == ("operations", "int32")
    assert ms == pytest.approx(3.7612, rel=1e-3)


@pytest.mark.parametrize("prop,d,draw,blocks", [
    ("Normal", 30, "icdf", 8), ("Normal", 30, "bm", 8),
    ("Normal", 31, "bm", 9),             # the odd d's angle in slot d+3
    ("Normal", 31, "icdf", 8), ("UniformRadius", 30, "icdf", 9),
    ("Laplace", 31, "bm", 8)])
def test_philox_blocks(prop, d, draw, blocks):
    assert cs.philox_blocks(prop, d, draw) == blocks


def test_bound_takes_the_largest_time():
    assert cs.bound(67e9, 0, 0) == (pytest.approx(1.0), "operations",
                                    "float32")
    assert cs.bound(0, 0, 3.35e9) == (pytest.approx(1.0), "bytes", "bytes")
    ms, by, limit = cs.bound(67e9, 2 * cs.PEAK_INT32_OPS / 1e3, 3.35e9)
    assert (ms, by, limit) == (pytest.approx(2.0), "operations", "int32")
    # the probes move bytes: fast_log on 8192 floats
    n = 8192
    assert cs.bound(cs.FAST_LOG_FLOPS * n, cs.FAST_LOG_INT_OPS * n,
                    8 * n)[2] == "bytes"


def test_the_rules_draw_stays_int32_bound_and_the_full_mvn_does_not():
    """At the flagship the rule's draw (CUDA's erfinvf, counted as Giles'
    polynomial) takes 24.2 ms of float work, under Philox's 37.6; the
    full-covariance MVN's d^2 quadratic form makes it float-bound."""
    w = cs.pt_work("rosenbrock", D, T, C, STEPS, 0, SWAP_EVERY,
                   draw="lax_erfinv")
    assert w[0] / cs.PEAK_F32_FLOPS * 1e3 == pytest.approx(24.231, rel=1e-3)
    assert cs.bound(*w)[2] == "int32"
    ms, _, limit = cs.bound(*cs.pt_work("mvn_full", D, T, C, STEPS, 0,
                                        SWAP_EVERY, draw="lax_erfinv",
                                        n_params=1 + D + D * D))
    assert limit == "float32" and ms == pytest.approx(56.135, rel=1e-3)


@pytest.mark.parametrize("impl", sorted(cs.NORMAL_FLOPS))
def test_draw_normals_bandwidth_shape_is_byte_bound(impl):
    """The probes' bandwidth shape: 2^24 normals write 4 x 2^24 =
    67,108,864 bytes, 20.03 us at 3.35 TB/s, more than their float work
    (at most 57 a normal, 14.3 us) or Philox's (15 int32 operations a
    normal, 15.0 us) takes."""
    n = cs.PROBE_BW_N
    assert n == 1 << 24
    flops, int_ops, nbytes = cs.probe_work("draw_normals", n, impl)
    assert nbytes == 67_108_864 and int_ops == 15 * n
    ms, by, limit = cs.bound(flops, int_ops, nbytes)
    assert (by, limit) == ("bytes", "bytes")
    assert ms == pytest.approx(0.0200325, rel=1e-5)


def test_fast_log_bandwidth_shape_is_byte_bound():
    """fast_log on 2^24 floats reads and writes 8 x 2^24 = 134,217,728
    bytes, 40.06 us at 3.35 TB/s; its 28 float and 6 int32 operations a
    float take 7.0 and 6.0 us."""
    flops, int_ops, nbytes = cs.probe_work("fast_log", cs.PROBE_BW_N)
    assert nbytes == 134_217_728
    assert (flops, int_ops) == (28 * cs.PROBE_BW_N, 6 * cs.PROBE_BW_N)
    ms, by, limit = cs.bound(flops, int_ops, nbytes)
    assert (by, limit) == ("bytes", "bytes")
    assert ms == pytest.approx(0.0400650, rel=1e-5)


def test_super_funnel_bound_counts_its_likelihood():
    """SuperFunnel at the reference's J = 5, K = 3, n = 20 (d = 26): 100
    observations of 2K + 7 flops and the priors' 109 a log-density, 1409;
    one MUFU (the expf) an observation, a limit that only this kind's work
    carries.  At the PT main path (65,536 x T = 8, 2000 steps) with every
    log-density's taus valid, float32 binds, 35.35 ms, over Philox's 26.33
    and the MUFU's 25.09."""
    assert cs.sf_lp_flops(5, 3, 20) == 1409
    evals = 65536 * 8 * 2001
    work = cs.pt_work("super_funnel", 26, 8, 65536, 2000, 0, 100,
                      draw="lax_erfinv", n_params=410, sf=(5, 3, 20, evals))
    assert work[3] == evals * 100 * cs.SF_MUFU_PER_OBS
    assert work[3] / cs.PEAK_MUFU_OPS * 1e3 == pytest.approx(25.088,
                                                             rel=1e-3)
    ms, by, limit = cs.bound(*work)
    assert (by, limit) == ("operations", "float32")
    assert ms == pytest.approx(35.355, rel=1e-3)
    assert cs.bound(0, 0, 0, 16 * 132 * 1.98e9) == (
        pytest.approx(1000.0), "operations", "mufu")


@pytest.mark.parametrize("share", [0.0, 0.3, 0.5])
def test_super_funnel_bound_counts_only_valid_likelihoods(share):
    """The kernels return -inf after the taus' test (2 flops) and compute
    neither the likelihood nor the priors where a tau is at most 1e-9, so
    the work counts the whole log-density and its MUFU on the valid
    evaluations alone: at half of them valid or fewer the PT main path's
    float work (24.34 ms at half) falls under Philox's 26.33 ms, which
    then binds."""
    evals = 65536 * 8 * 2001
    valid = int(evals * share)
    full = cs.pt_work("super_funnel", 26, 8, 65536, 2000, 0, 100,
                      draw="lax_erfinv", n_params=410, sf=(5, 3, 20, evals))
    work = cs.pt_work("super_funnel", 26, 8, 65536, 2000, 0, 100,
                      draw="lax_erfinv", n_params=410, sf=(5, 3, 20, valid))
    assert full[0] - work[0] == (evals - valid) * (1409 - 2)
    assert work[3] == valid * 100
    ms, by, limit = cs.bound(*work)
    assert (by, limit) == ("operations", "int32")
    assert ms == pytest.approx(26.329, rel=1e-3)
    rwm = cs.rwm_work("super_funnel", 26, 64, 10, sf=(5, 3, 20, 0))
    assert rwm[0] == cs.rwm_work("mvn_iso", 26, 64, 10)[0] \
        - 64 * 11 * cs.lp_flops("mvn_iso", 26) + 64 * 11 * 2
    assert rwm[3] == 0
