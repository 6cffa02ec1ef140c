"""The one-program iterative ladder builder
(``rwm_pt_tpu_torch.ladders.construct_iterative_ladder_device``, ROADMAP
A10) on the CPU, where it runs its plain version: its decisions held
exactly against JAX's ``construct_iterative_ladder_device`` with a
deterministic swap rate (the ``max_T`` cap, the rescue, the stop below
beta_min), the host builder's ladder on the shared Philox stream for every
target with a direct sampler, and the refusals (JAX's ladder within
Monte-Carlo error: ``test_torch_ladder_device_parity.py``).  The kernel itself is held on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 18)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from rwm_pt_tpu.ladders.ladders import \
    construct_iterative_ladder_device as jdevice
from rwm_pt_tpu.targets import get_target_distribution as jget
from rwm_pt_tpu_torch.kernels import draws
from rwm_pt_tpu_torch.kernels.ladder_build import (LADDER_KINDS,
                                                   ladder_kind,
                                                   sampler_params)
from rwm_pt_tpu_torch.ladders import (construct_iterative_ladder,
                                      construct_iterative_ladder_device)
from rwm_pt_tpu_torch.ladders import ladders as L
from rwm_pt_tpu_torch.targets import get_target_distribution as tget

torch.set_num_threads(1)
CPU = "cpu"


# ---- a deterministic swap rate: every sample of a side is the row (k log
# beta), the log-density its coordinate, so a_hat = exp(-k (beta - beta*)
# log(beta / beta*)) whatever the draws
@struct.dataclass
class JStub:
    k: float = struct.field(pytree_node=False, default=1.0)

    def direct_sample(self, key, n, beta=1.0):
        b = jnp.asarray(beta, jnp.float32)
        return jnp.full((n, 1), self.k * jnp.log(b), jnp.float32)

    def log_density(self, x):
        return x[..., 0]


class TStub:
    def __init__(self, k):
        self.k = k
        self.device = torch.device(CPU)

    def stream_sample(self, stream, n, beta, matmul_precision="float32"):
        return torch.full((n, 1), self.k) * torch.log(beta).expand(n, 1)

    def log_density(self, x):
        return x[..., 0]


@pytest.mark.parametrize("k,kw", [
    (4.0, dict(target_swap_acceptance_rate=0.3, tolerance=1e-3,
               max_pn_adjustment_steps=200)),
    (30.0, dict(target_swap_acceptance_rate=0.234, tolerance=1e-3,
                max_pn_adjustment_steps=200, max_T=5)),
    (6.0, dict(target_swap_acceptance_rate=0.3, tolerance=1e-9,
               max_pn_adjustment_steps=6,
               convergence_failure_tolerance_factor=1e9)),
    (1e-4, dict(target_swap_acceptance_rate=0.234, tolerance=1e-6,
                max_pn_adjustment_steps=50)),
    (6.0, dict(target_swap_acceptance_rate=0.3, tolerance=1e-9,
               max_pn_adjustment_steps=6,
               convergence_failure_tolerance_factor=1.0)),
], ids=["found", "max_T", "rescue", "stop_below_beta_min", "no_rescue"])
def test_decisions_equal_jax(k, kw):
    """One deterministic a_hat in both packages: the same rungs (JAX runs
    the recurrence in float32, the port in float64, as its kernel does)."""
    j = jdevice(JStub(k), N_samples_swap_est=8, **kw)
    p = L._construct_iterative_ladder_device_plain(
        TStub(k), N_samples_swap_est=8, **kw)
    assert len(p.betas) == len(j)
    np.testing.assert_allclose(p.betas, j, rtol=1e-5)
    assert p.betas == construct_iterative_ladder_device(
        TStub(k), N_samples_swap_est=8, **kw)
    if "max_T" in kw:
        assert len(j) == kw["max_T"] and j[-1] == pytest.approx(0.01)
    if kw.get("convergence_failure_tolerance_factor") == 1e9:
        # every rung rescued after its 6 probes
        assert p.probes == 6 * (len(p.betas) - 2) and len(p.betas) > 3
    if k == 1e-4:
        # a_hat ~ 1 drives beta* under beta_min: no rung, no rescue
        assert p.betas == [1.0, 0.01]
    if kw.get("convergence_failure_tolerance_factor") == 1.0:
        assert p.betas == [1.0, 0.01] and p.probes == 6


# every registry target with a direct sampler: one per kernel kind
KINDS = {"mvn_iso": ("MultivariateNormal", 5, {}),
         "mvn_full": ("MultivariateNormal", 4,
                      dict(cov=np.array([[2.0, .5, 0, 0], [.5, 1, .2, 0],
                                         [0, .2, 1, .3], [0, 0, .3, .5]]))),
         "scaled_mvn": ("MultivariateNormalScaled", 6, {}),
         "three_mixture": ("ThreeMixtureScaled", 10, {}),
         "rough_carpet": ("RoughCarpetScaled", 4, {}),
         "even_rosenbrock": ("EvenRosenbrock", 6, {}),
         "hybrid_rosenbrock": ("HybridRosenbrock", 0, dict(n1=3, n2=3)),
         "hypercube": ("Hypercube", 3, {}),
         "iid_gamma": ("IIDGamma", 3, {}),
         "iid_beta": ("IIDBeta", 2, {}),
         "neal_funnel": ("NealFunnel", 4, {})}


def test_every_kind_with_a_sampler_is_listed():
    assert sorted(KINDS) == sorted(LADDER_KINDS)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_device_builder_equals_host_builder(kind):
    """One seed, one probe stream: the host loop and the plain device
    builder take the same decisions and land the same ladder."""
    name, d, kw = KINDS[kind]
    tg = tget(name, d, device=CPU, **kw)
    assert ladder_kind(tg) == kind
    assert sampler_params(kind, tg).dtype == torch.float32
    opts = dict(N_samples_swap_est=400, tolerance=0.02,
                max_pn_adjustment_steps=25, seed=5)
    host = construct_iterative_ladder(tg, **opts)
    dev = L._construct_iterative_ladder_device_plain(tg, **opts)
    assert len(dev.betas) == len(host)
    np.testing.assert_allclose(dev.betas, host, rtol=1e-5)
    assert dev.betas[0] == 1.0 and dev.betas[-1] == 0.01
    assert dev.probes == len(dev.a_hats) >= len(host) - 2


@pytest.mark.parametrize("name", ["FullRosenbrock", "SuperFunnel"])
def test_targets_without_a_sampler_raise(name):
    for build in (construct_iterative_ladder_device,
                  construct_iterative_ladder):
        with pytest.raises(NotImplementedError, match="direct_sample"):
            build(tget(name, 4, device=CPU))
    with pytest.raises(NotImplementedError):
        ladder_kind(tget(name, 4, device=CPU))
    with pytest.raises(NotImplementedError, match="direct_sample"):
        jdevice(jget("FullRosenbrock", 4))


def test_partition_sum_is_the_kernels_order():
    """Tiles of 256 summed by the halving tree, tile r 256 + t added in
    order into slot t, the slots by the tree: a float64 sum."""
    rng = np.random.default_rng(0)
    for n in (1, 255, 256, 257, 70000):
        v = torch.from_numpy(rng.random(n).astype(np.float32))
        s = float(L.partition_sum(v))
        assert s == pytest.approx(float(v.double().sum()), rel=1e-12)
    v = torch.zeros(256 * 256 + 256, dtype=torch.float64)
    v[256 * 256] = 1.0          # tile 256: row 1, slot 0
    v[3] = 2.0
    assert float(L.partition_sum(v)) == 3.0


def test_probe_counters_carry_the_ladder_tag():
    """A probe's counters have the tag in the word where a fused run keeps
    its rung (< 32), so no probe word is a fused run's; the words are
    Philox of (block, sample, tag | side << 20, probe)."""
    key = draws.seed_key(9)
    w = draws.ladder_words(key, 3, 1, 5, 7, CPU)
    assert w.shape == (5, 7)
    blk = draws.philox4x32(torch.tensor(1), torch.tensor(4),
                           torch.tensor(draws.LADDER_TAG | 1 << 20),
                           torch.tensor(3), *key)
    assert [int(b) for b in blk[:3]] == [int(x) for x in w[4, 4:7]]
    fused = draws.slot_words(key, 3, 2, 8, 5, CPU)
    assert not set(fused.flatten().tolist()) & set(w.flatten().tolist())


def test_gamma_stream_draws_the_gamma_law():
    """Marsaglia-Tsang on the stream: mean and variance of Gamma(a) for a
    shape above and below 1 (the boost), NaN for a NaN shape."""
    for a in (2.0, 0.3):
        g = draws.ladder_gamma(draws.seed_key(1), 1, 0, 0,
                               torch.tensor(a), 20000, 2, CPU)
        assert float(g.mean()) == pytest.approx(a, rel=0.03)
        assert float(g.var()) == pytest.approx(a, rel=0.08)
    g = draws.ladder_gamma(draws.seed_key(1), 1, 0, 0,
                           torch.tensor(math.nan), 3, 2, CPU)
    assert torch.isnan(g).all()


def test_bfloat16_operands_change_the_full_mvn_only_slightly():
    """``matmul_precision='bfloat16'`` rounds the MVN's product operands:
    the plain builder still builds a ladder of the same length."""
    tg = tget("MultivariateNormal", 4, device=CPU, cov=KINDS["mvn_full"][2][
        "cov"])
    opts = dict(N_samples_swap_est=2000, tolerance=0.02, seed=2)
    a = construct_iterative_ladder_device(tg, **opts)
    b = construct_iterative_ladder_device(tg, matmul_precision="bfloat16",
                                          **opts)
    assert len(a) == len(b) and a != b
    np.testing.assert_allclose(a, b, rtol=0.05)
    with pytest.raises(ValueError, match="matmul_precision"):
        construct_iterative_ladder_device(tg, matmul_precision="tf32")


# ---- csrc/ladder_build.cu's reduction and its folded log-densities,
# emulated: the tree by the kernel's lanes, the grid, the lp's order
def _shfl_tree16(lanes: torch.Tensor) -> torch.Tensor:
    """``tree16`` over the 32 lanes of warps ``lanes`` ``(..., 32)``:
    each level every lane adds the lane ``w`` above it
    (``__shfl_down_sync``; past lane 31 its own value), w = 8, 4, 2, 1."""
    for w in (8, 4, 2, 1):
        up = torch.cat([lanes[..., w:], lanes[..., 32 - w:]], dim=-1)
        lanes = lanes + up
    return lanes


def _warp_tile_sum(v: torch.Tensor) -> torch.Tensor:
    """A tile's 256 float64 terms summed as the kernel sums them: sample
    16 j + u in lane j of unit u (lanes 16-31, the samples' other sides,
    hold 0), tree16 in each unit, the units' partials in lanes 0-15 of one
    warp, tree16 again."""
    units = torch.zeros(16, 32, dtype=torch.float64)
    units[:, :16] = v.reshape(16, 16).T          # [u, j] = v[16 j + u]
    red = _shfl_tree16(units)[:, 0]
    warp = torch.zeros(32, dtype=torch.float64)
    warp[:16] = red
    return _shfl_tree16(warp)[0]


def _terms(kind: str, n: int, seed: int) -> torch.Tensor:
    """float64 terms as a probe makes them: float32 values in [0, 1] of
    wide spread, a few NaN (a probe at a NaN beta*) where asked."""
    rng = np.random.default_rng(seed)
    v = (rng.random(n) ** 8).astype(np.float32).astype(np.float64)
    if kind == "nan":
        v[rng.integers(0, n, 3)] = np.nan
    if kind == "ones":
        v[:] = 1.0
    return torch.from_numpy(v)


@pytest.mark.parametrize("kind,seed", [("wide", 0), ("wide", 1),
                                       ("ones", 2), ("nan", 3)])
def test_warp_tile_tree_equals_tree(kind, seed):
    """The kernel's tile sum (shuffles within a unit, then across the 16
    units) pairs what ``_tree`` pairs: equal bit for bit."""
    v = _terms(kind, 256, seed)
    got, want = _warp_tile_sum(v), L._tree(v)
    if kind == "nan":
        assert torch.isnan(got) and torch.isnan(want)
    else:
        assert got.item() == want.item()


def _grid_partition_sum(v: torch.Tensor, grid: int, layout: str) -> float:
    """``partition_sum`` as a grid of ``grid`` blocks computes it, blocks
    in reverse order of their index: "tiles" (the unrolled buckets) take
    whole tiles grid-stride and write each tile's sum; "units" (the rolled
    buckets: 8 warps a block) take warp-units grid-stride and write their
    partials, which a tile's last unit sums (levels 8 .. 1).  Then slot t
    adds tiles t, t + 256, ... in order and the slots' tree pairs them by
    (j, u) as the tiles' does."""
    n_tiles = -(-v.numel() // L.TILE)
    v = torch.nn.functional.pad(v, (0, n_tiles * L.TILE - v.numel()))
    tiles = v.reshape(n_tiles, L.TILE)
    sums = torch.full((n_tiles,), math.nan, dtype=torch.float64)
    if layout == "tiles":
        for b in reversed(range(grid)):
            for t in range(b, n_tiles, grid):
                sums[t] = _warp_tile_sum(tiles[t])
    else:
        parts = torch.full((n_tiles * 16,), math.nan, dtype=torch.float64)
        for b in reversed(range(grid)):
            for w in range(8):
                for u in range(b * 8 + w, n_tiles * 16, grid * 8):
                    lanes = torch.zeros(32, dtype=torch.float64)
                    lanes[:16] = tiles[u // 16].reshape(16, 16)[:, u % 16]
                    parts[u] = _shfl_tree16(lanes)[0]
        for t in range(n_tiles):
            lanes = torch.zeros(32, dtype=torch.float64)
            lanes[:16] = parts[16 * t:16 * t + 16]
            sums[t] = _shfl_tree16(lanes)[0]
    slots = torch.zeros(L.TILE, dtype=torch.float64)
    for t in range(L.TILE):
        acc = torch.zeros((), dtype=torch.float64)
        for r in range(t, n_tiles, L.TILE):
            acc = acc + sums[r]
        slots[t] = acc
    return _warp_tile_sum(slots).item()


@pytest.mark.parametrize("layout", ["tiles", "units"])
@pytest.mark.parametrize("grid", [1, 12, 264])
def test_partition_sum_does_not_depend_on_the_grid(grid, layout):
    """Which block sums a tile, and in what order the blocks run, changes
    nothing: the sum is ``partition_sum``'s bit for bit on any grid (a
    probe of N = 70,000 samples: 274 tiles, two rows of slots)."""
    v = _terms("wide", 70000, grid)
    assert _grid_partition_sum(v, grid, layout) == L.partition_sum(v).item()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_target_words_made_once_a_target(kind):
    """``_build.kernel_target``'s words and the ladder wrapper's (made
    from them, with the sampler's) are made once a target: a second call
    returns the same tensor, equal to words made afresh; another target of
    the same kind gets its own; the entry goes with its target."""
    import gc

    from rwm_pt_tpu_torch.kernels import _build, ladder_build
    name, d, kw = KINDS[kind]
    tg = tget(name, d, device=CPU, **kw)
    got = _build.kernel_target(tg)
    assert _build.kernel_target(tg)[1] is got[1]
    assert got[0] == kind
    assert torch.equal(got[1], _build._kernel_target(tg)[1])
    other = tget(name, d, device=CPU, **kw)
    assert _build.kernel_target(other)[1] is not got[1]
    words = ladder_build._words(tg, kind)   # made from kernel_target's
    assert ladder_build._words(tg, kind)[1] is words[1]
    assert torch.equal(words[0], got[1])
    assert torch.equal(words[1], sampler_params(kind, tg))
    assert _build.kernel_target(tg)[1] is got[1]
    key = id(tg)
    assert key in _build._PER_TARGET
    del tg, got, words
    gc.collect()
    assert key not in _build._PER_TARGET


def test_per_target_keeps_nothing_that_raises():
    """A target no kernel takes raises each time and leaves no entry."""
    from rwm_pt_tpu_torch.kernels import _build

    class Custom:
        dim = 3
    t = Custom()
    for _ in range(2):
        with pytest.raises(NotImplementedError):
            _build.kernel_target(t)
    assert id(t) not in _build._PER_TARGET


@pytest.mark.parametrize("stamps", [False, True])
def test_ladder_measuring_build_is_its_own_library(stamps):
    """``ladder_lib(..., stamps=True)`` names the measuring build: the same
    kind and bucket with ``-DRWM_PT_LADDER_STAMPS``, in a file of its own;
    the ladder kernel's library carries no stamps."""
    from rwm_pt_tpu_torch.kernels import _build
    name = _build.ladder_lib("three_mixture", 10, stamps)
    flags = _build._flags(name)
    assert ("-DRWM_PT_LADDER_STAMPS" in flags) == stamps
    assert f"-DRWM_PT_TARGET={_build.TARGET_KINDS['three_mixture']}" in flags
    assert "-DRWM_PT_DMAX=16" in flags
    assert name.endswith(".stamps") == stamps
    assert (_build._lib_path(name) == _build._lib_path(
        _build.ladder_lib("three_mixture", 10))) == (not stamps)


def _rn32(x):
    """The float32 nearest the rational ``x`` (ties to even), without
    rounding twice."""
    from fractions import Fraction
    c = np.float32(float(x))
    near = (np.nextafter(c, np.float32(-np.inf)), c,
            np.nextafter(c, np.float32(np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                    int(v.view(np.uint32)) & 1))


@pytest.mark.parametrize("case", ["draws", "adversarial"])
def test_div_by_rounds_as_the_quotient(case):
    """csrc/ladder_build.cu::div_by, a / b from y = RN(1 / b) as RN(q +
    RN(a - b q) y) with q = RN(a y) (each FMA one rounding, exact rational
    arithmetic here), equals the IEEE quotient RN(a / b) for the
    mixtures' quotients (a normal over sqrt(beta), a mean plus that over
    a scale) and where q is least accurate: b just below a power of two,
    a / b near the top of its binade (Markstein's theorem)."""
    from fractions import Fraction as F
    rng = np.random.default_rng(0 if case == "draws" else 1)
    f32 = np.float32
    for _ in range(2000):
        if case == "draws":
            b = f32(np.sqrt(f32(rng.uniform(0.01, 1.0))))
            a = f32(rng.normal() * 3 + rng.choice([0.0, 5.0, -5.0, 100.0]))
        else:
            b = f32(np.ldexp(1.0, int(rng.integers(-3, 3)))
                    * (1 - rng.integers(1, 2000) * 2.0 ** -24))
            a = f32(np.ldexp(1.0, int(rng.integers(-3, 4)))
                    * (2 - rng.integers(1, 4000) * 2.0 ** -24) * float(b))
        y = f32(1) / b
        q = a * y
        r = _rn32(F(float(a)) - F(float(b)) * F(float(q)))
        got = _rn32(F(float(q)) + F(float(r)) * F(float(y)))
        assert got == a / b, (a, b)
