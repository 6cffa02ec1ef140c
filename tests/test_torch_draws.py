"""The port's counter-based draws (rwm_pt_tpu_torch/kernels/draws.py):
Philox4x32-10 against Random123's known answers, the Giles erfinv against
the JAX package's, the normals' distributions, the draw study's bit-trick
log and draws against pallas_rwm.py's, the slot layout of the three
proposals, and the Laplace and uniform-ball increments against
pallas_rwm.py's own on the same uniforms and normals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from scipy.stats import norm

from rwm_pt_tpu.kernels import pallas_rwm
from rwm_pt_tpu.kernels.pallas_rwm import _erfinv_giles
from rwm_pt_tpu_torch.kernels import draws

torch.set_num_threads(1)

M = 0xFFFFFFFF
KAT = [  # (counter, key, expected) from Random123's kat_vectors
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    words = draws.philox4x32(*[torch.tensor([c], dtype=torch.int64)
                               for c in ctr], *key)
    assert tuple(int(w) for w in words) == want


def test_uniform_shift_is_logical():
    """Words with the top bit set must give uniforms in [0.5, 1), never
    negative ones (the arithmetic-shift trap of pallas_rwm.py:44-46)."""
    w = torch.tensor([0, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF],
                     dtype=torch.int64)
    u = draws.uniform_from_bits(w)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        u.numpy(), np.array([0.0, 0.5, 1 - 2 ** -24, 0.5 - 2 ** -24],
                            np.float32))


def test_erfinv_giles_matches_jax():
    x = np.linspace(-1 + 1.2e-7, 1 - 1.2e-7, 200001).astype(np.float32)
    ours = draws.erfinv_giles(torch.from_numpy(x)).numpy()
    ref = np.asarray(_erfinv_giles(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_normal_icdf_distribution():
    """Moments and KS of 2^20 Philox ICDF normals, with the bounds of
    test_pallas_kernels.py::test_normal_impl_icdf_distribution."""
    N = 1 << 20
    words = draws.slot_words(draws.seed_key(12345), 1, 1, 64, N // 64,
                             "cpu")
    z = np.sort(draws.normal_icdf(draws.uniform_from_bits(words))
                .numpy().ravel().astype(np.float64))
    assert z.size == N
    assert abs(z.mean()) < 5e-3
    assert abs(z.std() - 1.0) < 5e-3
    assert abs((z ** 3).mean()) < 2e-2
    assert abs((z ** 4).mean() - 3.0) < 5e-2
    q = (np.arange(N) + 0.5) / N
    assert np.max(np.abs(norm.cdf(z) - q)) < 3.5e-3


def test_slot_layout():
    """Slot j of (rung t, replica c, step) is word j % 4 of the Philox block
    with counter (j // 4, c, t, step)."""
    key = draws.seed_key(0xDEADBEEF12345)
    words = draws.slot_words(key, 7, 3, 10, 5, "cpu")
    assert words.shape == (3, 10, 5)
    for t, j, c in [(0, 0, 0), (2, 9, 4), (1, 5, 3)]:
        blk = draws.philox4x32(*[torch.tensor([v], dtype=torch.int64)
                                 for v in (j // 4, c, t, 7)], *key)
        assert int(words[t, j, c]) == int(blk[j % 4])


def test_step_draws_shapes_and_seed_mixing():
    n, u, us, ur = draws.step_draws(draws.seed_key(3), 1, 4, 6, 8, "cpu")
    assert n.shape == (4, 6, 8) and u.shape == (4, 8) and us.shape == (4, 8)
    assert ur is None
    n2, _, _, _ = draws.step_draws(draws.seed_key(3), 2, 4, 6, 8, "cpu")
    assert not torch.equal(n, n2)
    g = torch.Generator().manual_seed(0)
    assert draws.resolve_seed(g) == draws.resolve_seed(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kind", ["Normal", "Laplace", "UniformRadius"])
def test_step_draws_slots_per_proposal(kind):
    """Every kind reads its increment words from slots 0..d-1 and its MH
    uniform from slot d; Normal's words are the ones it read before slot
    d+2 existed, and UniformRadius adds its radius uniform at slot d+2."""
    key, d, T, C = draws.seed_key(77), 6, 3, 5
    words = draws.slot_words(key, 4, T, d + 3, C, "cpu")
    inc, u, us, ur = draws.step_draws(key, 4, T, d, C, "cpu", kind=kind)
    u_words = draws.uniform_from_bits(words)
    want = u_words[:, :d] if kind == "Laplace" else draws.normal_icdf(
        u_words[:, :d])
    assert torch.equal(inc, want)
    assert torch.equal(u, u_words[:, d]) and torch.equal(us, u_words[:, d + 1])
    if kind == "UniformRadius":
        assert torch.equal(ur, u_words[:, d + 2])
    else:
        assert ur is None


def _laplace_uniforms(shape):
    """Uniforms on the 2^-24 grid with both edge cases: 0.5 (a zero
    increment, sign(0) = 0) and 0 (the clamp)."""
    rng = np.random.default_rng(3)
    u = (rng.integers(0, 1 << 24, shape) * 2.0 ** -24).astype(np.float32)
    u.flat[0], u.flat[1] = 0.5, 0.0
    return u


def test_laplace_increment_matches_pallas(monkeypatch):
    """rtol 1e-6: the same f32 arithmetic on both sides (log1p may differ by
    an ulp between the two libraries)."""
    d, C = 7, 64
    u = _laplace_uniforms((d, C))
    scale = np.linspace(0.1, 2.0, d).astype(np.float32)[:, None]
    monkeypatch.setattr(pallas_rwm, "_uniform", lambda shape: jnp.asarray(u))
    ref = np.asarray(pallas_rwm._laplace((d, C), jnp.asarray(scale)))
    ours = draws.laplace_increment(torch.from_numpy(u),
                                   torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert ours.flat[0] == 0.0 and np.isfinite(ours).all()
    # u = 0: v = -0.5, sign -1, the clamp at -0.999999
    np.testing.assert_allclose(ours.flat[1], 0.1 * np.log1p(
        np.float32(-0.999999)), rtol=1e-6)


def test_uniform_ball_increment_matches_pallas(monkeypatch):
    """rtol 1e-6 (the norm's sum may be taken in another order); a radius
    uniform of 0 gives a zero increment."""
    d, C = 5, 64
    rng = np.random.default_rng(4)
    n = rng.standard_normal((d, C)).astype(np.float32)
    ur = rng.random((1, C), dtype=np.float32)
    ur[0, 0] = 0.0
    monkeypatch.setattr(pallas_rwm, "_normal",
                        lambda shape, impl=None: jnp.asarray(n))
    monkeypatch.setattr(pallas_rwm, "_uniform",
                        lambda shape: jnp.asarray(ur))
    ref = np.asarray(pallas_rwm._uniform_ball((d, C), jnp.float32(0.7)))
    ours = draws.uniform_ball_increment(torch.from_numpy(n),
                                        torch.from_numpy(ur[0]),
                                        0.7).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    assert (ours[:, 0] == 0).all()
    r = np.sqrt((ours ** 2).sum(0))
    assert (r <= 0.7 * (1 + 1e-6)).all()


def _bm_uniforms(half, C, seed):
    """u1 and u2 on the 2^-24 grid, u1 with a 0 (the 1e-7 clamp)."""
    rng = np.random.default_rng(seed)
    u1, u2 = ((rng.integers(0, 1 << 24, (half, C)) * 2.0 ** -24).astype(
        np.float32) for _ in range(2))
    u1[0, 0] = 0.0
    return u1, u2


@pytest.mark.parametrize("d", [1, 6, 7])
def test_normal_bm_matches_pallas(monkeypatch, d):
    """Box-Muller against ``pallas_rwm._normal_bm`` on the same uniforms,
    odd d included: coordinate k takes r cos theta of pair k, coordinate
    k + ceil(d/2) its r sin theta; rtol 1e-5 (cos and sin may differ by an
    ulp between the two libraries)."""
    C, half = 64, (d + 1) // 2
    u1, u2 = _bm_uniforms(half, C, d)
    feed = [jnp.asarray(u1), jnp.asarray(u2)]
    monkeypatch.setattr(pallas_rwm, "_uniform", lambda shape: feed.pop(0))
    ref = np.asarray(pallas_rwm._normal_bm((d, C)))
    ours = draws.normal_bm(torch.from_numpy(u1), torch.from_numpy(u2),
                           d).numpy()
    assert ours.shape == ref.shape == (d, C)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=2e-6)
    assert np.isfinite(ours).all()


def test_uniform_ball_bm_matches_pallas(monkeypatch):
    """UniformRadius draws its direction from the Box-Muller normals
    (``_uniform_ball(impl="bm")``) at an odd d."""
    d, C = 5, 64
    u1, u2 = _bm_uniforms(3, C, 9)
    ur = np.random.default_rng(2).random((1, C), dtype=np.float32)
    feed = [jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(ur)]
    monkeypatch.setattr(pallas_rwm, "_uniform", lambda shape: feed.pop(0))
    ref = np.asarray(pallas_rwm._uniform_ball((d, C), jnp.float32(0.7),
                                              "bm"))
    n = draws.normal_bm(torch.from_numpy(u1), torch.from_numpy(u2), d)
    ours = draws.uniform_ball_increment(n, torch.from_numpy(ur[0]),
                                        0.7).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["Normal", "UniformRadius"])
@pytest.mark.parametrize("d", [6, 7])
def test_step_draws_bm_slots(kind, d):
    """With the Box-Muller draw, pair k reads u1 from slot k and u2 from
    slot ceil(d/2) + k, or d+3 for the last pair of an odd d; the MH, swap
    and radius uniforms keep their slots."""
    key, T, C = draws.seed_key(5), 3, 4
    s1, s2 = draws.bm_slots(d)
    h = (d + 1) // 2
    assert s1 == list(range(h))
    assert s2 == [h + k if h + k < d else d + 3 for k in range(h)]
    words = draws.uniform_from_bits(draws.slot_words(key, 9, T, d + 4, C,
                                                     "cpu"))
    inc, u, us, ur = draws.step_draws(key, 9, T, d, C, "cpu", kind=kind,
                                      draw="bm")
    want = draws.normal_bm(words[:, s1].transpose(0, 1),
                           words[:, s2].transpose(0, 1), d).transpose(0, 1)
    assert torch.equal(inc, want)
    assert torch.equal(u, words[:, d]) and torch.equal(us, words[:, d + 1])
    if kind == "UniformRadius":
        assert torch.equal(ur, words[:, d + 2])
    # the ICDF stream is untouched by the Box-Muller slots
    icdf = draws.step_draws(key, 9, T, d, C, "cpu", kind=kind)[0]
    assert torch.equal(icdf, draws.normal_icdf(words[:, :d]))


def test_normal_bm_distribution():
    """Box-Muller normals from the Philox stream: N(0, 1) by moments and a
    Kolmogorov-Smirnov distance."""
    inc = draws.step_draws(draws.seed_key(3), 1, 1, 7, 40000, "cpu",
                           draw="bm")[0].double().flatten().numpy()
    assert abs(inc.mean()) < 5 / np.sqrt(inc.size)
    assert abs(inc.var() - 1.0) < 5 * np.sqrt(2.0 / inc.size)
    xs = np.sort(inc)
    ks = np.abs(norm.cdf(xs) - np.arange(1, xs.size + 1) / xs.size).max()
    assert ks < 1.63 / np.sqrt(xs.size)


def test_resolve_normal_impl(monkeypatch):
    """The JAX signature and override, with the rule measured on the H100
    on the shared-memory kernels: CUDA's erfinvf draw (``lax_erfinv``) for
    both kernels at every size and on every target kind, the studies' 1024
    replicas or chains and the full-covariance MVN included; NORMAL_IMPL
    wins and takes all five draws of the JAX package (the rule never picks
    the fake uniform); an unknown name raises ValueError."""
    for block in (512, 1024, 1025, 65536):
        for kernel in ("pt", "rwm"):
            for kind in (None, "rosenbrock", "three_mixture", "rough_carpet",
                         "mvn_full"):
                assert draws.resolve_normal_impl(kernel, block, kind) == (
                    "lax_erfinv")
    with pytest.raises(ValueError, match="kernel"):
        draws.resolve_normal_impl("mala", 65536)
    assert set(draws.NORMAL_IMPLS) == set(pallas_rwm._NORMAL_IMPLS)
    for impl in draws.NORMAL_IMPLS:
        monkeypatch.setattr(draws, "NORMAL_IMPL", impl)
        assert draws.resolve_normal_impl("pt", 65536) == impl
        assert draws.resolve_normal_impl("rwm", 512, "mvn_full") == impl
    monkeypatch.setattr(draws, "NORMAL_IMPL", "ziggurat")
    with pytest.raises(ValueError, match="unknown normal draw 'ziggurat'"):
        draws.resolve_normal_impl("rwm", 512)


# the 8192 inputs of tests/test_pallas_kernels.py::test_fast_log_accuracy_
# interpret: the magnitudes the ICDF feeds the log
FAST_LOG_Y = np.concatenate([
    np.logspace(-37, 0, 4096).astype(np.float32),
    np.random.default_rng(0).uniform(1e-7, 1.0, 4096).astype(np.float32),
]).reshape(8, 1024)


def _interpret(fn, *inputs, shape):
    """``fn(*input values)`` inside a Pallas kernel run by the TPU
    interpreter on the CPU, as the JAX package's tests run ``_fast_log``
    (``pltpu.bitcast`` fails eagerly there)."""
    def kernel(*refs):
        refs[-1][...] = fn(*[r[...] for r in refs[:-1]])
    return np.asarray(pl.pallas_call(
        kernel, in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(inputs),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=pltpu.InterpretParams())(*map(jnp.asarray, inputs)))


def test_fast_log_matches_jax():
    """``draws.fast_log`` against ``pallas_rwm._fast_log`` (interpreted) to
    2 f32 ulp (rtol 2.4e-7: XLA may contract the polynomial's products
    into FMAs), and against float64 log under the JAX test's own bound
    ``1e-6 + 1e-7 |log y|``."""
    ref = _interpret(pallas_rwm._fast_log, FAST_LOG_Y, shape=(8, 1024))
    ours = draws.fast_log(torch.from_numpy(FAST_LOG_Y)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=2.4e-7, atol=1e-30)
    exact = np.log(FAST_LOG_Y.astype(np.float64))
    err = np.abs(ours.astype(np.float64) - exact)
    assert (err < 1e-6 + 1e-7 * np.abs(exact)).all()


def _grid_uniforms(shape, seed, lo=0):
    """Uniforms on the 2^-24 grid in [lo 2^-24, 1) with both ends."""
    u = (np.random.default_rng(seed).integers(lo, 1 << 24, shape)
         * 2.0 ** -24).astype(np.float32)
    u.flat[0], u.flat[1] = lo * 2.0 ** -24, 1 - 2.0 ** -24
    return u


def test_normal_icdf_fastlog_matches_jax(monkeypatch):
    """``normal_icdf_fastlog`` against ``pallas_rwm._normal_icdf_fastlog``
    fed the same uniforms inside the interpreted kernel.  The interpreter
    rounds ``x = 2u - 1 + 2^-24`` in another order, by up to one ulp of 1
    (2^-24 below it), which the lower tail magnifies by dz/dx =
    sqrt(pi/2) exp(z^2/2); so the bound per element is two such ulps times
    that slope, plus 1e-6.  u = 0 is left out: there the interpreted
    kernel gives 504.87 (ROADMAP Queue C).  Against the port's ICDF
    normal, whose Giles erfinv matches JAX's to 1e-6, the bit-trick log
    moves z by < 2e-6 everywhere, u = 0 included."""
    u = _grid_uniforms((32, 128), 1, lo=1)
    held = {}
    monkeypatch.setattr(pallas_rwm, "_uniform", lambda shape: held["u"])

    def fn(uv):
        held["u"] = uv
        return pallas_rwm._normal_icdf_fastlog(uv.shape)
    ref = _interpret(fn, u, shape=u.shape)
    ours = draws.normal_icdf_fastlog(torch.from_numpy(u)).numpy()
    slope = np.sqrt(np.pi / 2) * np.exp(ref.astype(np.float64) ** 2 / 2)
    assert (np.abs(ours - ref) < 2 * 2.0 ** -24 * slope + 1e-6).all()
    u[0, 0] = 0.0
    t = torch.from_numpy(u)
    icdf = draws.normal_icdf(t).numpy()
    fast = draws.normal_icdf_fastlog(t).numpy()
    assert np.isfinite(fast).all() and np.abs(fast - icdf).max() < 2e-6


@pytest.mark.parametrize("impl", ["lax_erfinv", "fake_uniform"])
def test_study_draws_match_jax(monkeypatch, impl):
    """``normal_laxerfinv`` and ``normal_fake_uniform`` against
    ``pallas_rwm``'s, eagerly, on the same uniforms.  fake_uniform is the
    same f32 arithmetic, bit for bit.  lax_erfinv: XLA and PyTorch
    approximate erfinv differently (XLA by Giles' f32 polynomial, whose own
    relative error in the tail branch is a few 1e-6), so rtol 1e-5."""
    u = _grid_uniforms((32, 128), 2)
    monkeypatch.setattr(pallas_rwm, "_uniform",
                        lambda shape: jnp.asarray(u))
    ref = np.asarray(pallas_rwm._NORMAL_IMPLS[impl](u.shape))
    ours = draws.ICDF_LAYOUT[impl](torch.from_numpy(u)).numpy()
    assert np.isfinite(ours).all()
    if impl == "fake_uniform":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["icdf_fastlog", "lax_erfinv", "bm"])
def test_study_draw_distribution(impl):
    """Moments and KS of 2^20 Philox normals of each exact draw from
    ``step_draws`` (d=64 coordinates of 16,384 chains), with the bounds of
    test_pallas_kernels.py::test_normal_impl_icdf_distribution."""
    N = 1 << 20
    z = np.sort(draws.step_draws(draws.seed_key(12345), 1, 1, 64, N // 64,
                                 "cpu", swap=False, draw=impl)[0]
                .numpy().ravel().astype(np.float64))
    assert z.size == N and np.isfinite(z).all()
    assert abs(z.mean()) < 5e-3
    assert abs(z.std() - 1.0) < 5e-3
    assert abs((z ** 3).mean()) < 2e-2
    assert abs((z ** 4).mean() - 3.0) < 5e-2
    q = (np.arange(N) + 0.5) / N
    assert np.max(np.abs(norm.cdf(z) - q)) < 3.5e-3


@pytest.mark.parametrize("kind", ["Normal", "UniformRadius"])
@pytest.mark.parametrize("impl", ["icdf_fastlog", "lax_erfinv",
                                  "fake_uniform"])
def test_step_draws_study_draws_read_icdf_slots(kind, impl):
    """The draw-study draws read the ICDF slot layout: normal i from slot
    i, the MH, swap and radius uniforms in slots d, d+1, d+2, no slot
    d+3; Laplace ignores the draw."""
    key, d, T, C = draws.seed_key(21), 7, 3, 5
    words = draws.uniform_from_bits(draws.slot_words(key, 4, T, d + 3, C,
                                                     "cpu"))
    inc, u, us, ur = draws.step_draws(key, 4, T, d, C, "cpu", kind=kind,
                                      draw=impl)
    assert torch.equal(inc, draws.ICDF_LAYOUT[impl](words[:, :d]))
    assert torch.equal(u, words[:, d]) and torch.equal(us, words[:, d + 1])
    if kind == "UniformRadius":
        assert torch.equal(ur, words[:, d + 2])
    lap = draws.step_draws(key, 4, T, d, C, "cpu", kind="Laplace",
                           draw=impl)[0]
    assert torch.equal(lap, words[:, :d])


@pytest.mark.parametrize("impl", list(draws.NORMAL_IMPLS))
def test_draw_normals_probe_plain(impl):
    """The normal-draw probe's plain version (draw_probes.py, the port of
    tests/test_pallas_kernels.py:399-412): an (8, n/8) block whose column
    j holds the d = 8 increment normals of replica j at rung 0 and absolute
    step 1, row k from slot k (Box-Muller: rows k and k + 4 from the pair
    of slots k and 4 + k)."""
    from rwm_pt_tpu_torch.kernels import draw_probes
    z = draw_probes.draw_normals(impl, 99, 64, device="cpu")
    assert z.shape == (8, 8) and z.dtype == torch.float32
    u = draws.uniform_from_bits(draws.slot_words(draws.seed_key(99), 1, 1,
                                                 8, 8, "cpu"))[0]
    want = (draws.normal_bm(u[:4], u[4:], 8) if impl == "bm"
            else draws.ICDF_LAYOUT[impl](u))
    assert torch.equal(z, want)
    assert not draw_probes.draw_normals.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        draw_probes.draw_normals(impl, 99, 60, device="cpu")
    with pytest.raises(ValueError, match="unknown normal draw"):
        draw_probes.draw_normals("ziggurat", 99, 64, device="cpu")


def test_fast_log_probe_plain_matches_jax():
    """The fast_log probe (the port of tests/test_pallas_kernels.py:
    459-468) on a CPU tensor runs its plain version, held against JAX's
    interpreted probe on the same 8192 inputs to 2 ulp, and launches
    nothing."""
    from rwm_pt_tpu_torch.kernels import draw_probes
    ref = _interpret(pallas_rwm._fast_log, FAST_LOG_Y, shape=(8, 1024))
    out = draw_probes.fast_log(torch.from_numpy(FAST_LOG_Y))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2.4e-7, atol=1e-30)
    assert not draw_probes.fast_log.launches


@pytest.mark.parametrize("impl", list(draws.NORMAL_IMPLS))
def test_draw_normals_probe_fills_out(impl):
    """``draw_normals(..., out=)`` on the CPU writes the plain version's
    normals into the given tensor and returns it: the values of a call
    without ``out``, whatever ``out`` held, and again when reused."""
    from rwm_pt_tpu_torch.kernels import draw_probes
    want = draw_probes.draw_normals(impl, 99, 64, device="cpu")
    out = torch.full((8, 8), float("nan"))
    got = draw_probes.draw_normals(impl, 99, 64, device="cpu", out=out)
    assert got is out and torch.equal(out, want)
    other = draw_probes.draw_normals(impl, 100, 64, device="cpu")
    assert draw_probes.draw_normals(impl, 100, 64, device="cpu",
                                    out=out) is out
    assert torch.equal(out, other) and not torch.equal(out, want)
    assert not draw_probes.draw_normals.launches


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_fast_log_probe_fills_out(offset):
    """``fast_log(y, out=)`` on the CPU writes the plain version's logs of
    ``y`` (a view at ``offset`` floats into the JAX test's inputs) into the
    given tensor and returns it, equal to a call without ``out``."""
    from rwm_pt_tpu_torch.kernels import draw_probes
    y = torch.from_numpy(FAST_LOG_Y).flatten()[offset:]
    out = torch.full_like(y, float("nan"))
    got = draw_probes.fast_log(y, out=out)
    assert got is out and torch.equal(out, draw_probes.fast_log(y))
    assert torch.equal(out, draws.fast_log(y))
    assert not draw_probes.fast_log.launches


def _bad_outs(shape):
    """``out`` tensors that the probes refuse for an output of ``shape``:
    wrong shape, type, device, or not contiguous."""
    rows, cols = shape
    return {"shape": torch.empty(rows, cols + 1),
            "dtype": torch.empty(shape, dtype=torch.float64),
            "device": torch.empty(shape, device="meta"),
            "contiguity": torch.empty(cols, rows).t()}


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "contiguity"])
def test_probe_out_is_checked(bad):
    """A wrong shape, type or device for ``out``, or an ``out`` that is not
    contiguous, raises in either probe before anything is written."""
    from rwm_pt_tpu_torch.kernels import draw_probes
    out = _bad_outs((8, 8))[bad]
    with pytest.raises(ValueError, match="out must be a contiguous float32"):
        draw_probes.draw_normals("bm", 99, 64, device="cpu", out=out)
    y = torch.from_numpy(FAST_LOG_Y[:, :8].copy())
    with pytest.raises(ValueError, match="out must be a contiguous float32"):
        draw_probes.fast_log(y, out=_bad_outs((8, 8))[bad])
    assert not draw_probes.draw_normals.launches
    assert not draw_probes.fast_log.launches


@pytest.mark.parametrize("y_at,out_at,ok", [
    (0, 0, True),      # out is y: in place
    (0, 64, True),     # apart in one storage
    (0, 1, False),     # out one float past y
    (1, 0, False),     # out one float before y
    (3, 60, False),    # out's last float is y's first
])
def test_fast_log_out_overlapping_y(y_at, out_at, ok):
    """``fast_log(y, out=)`` takes ``y`` itself (in place) or memory apart
    from it, and refuses an ``out`` that partly overlaps ``y`` (a shifted
    view of the same storage), before anything is written."""
    from rwm_pt_tpu_torch.kernels import draw_probes
    y0 = torch.from_numpy(FAST_LOG_Y).flatten()[:63].clone()
    buf = torch.ones(130)
    buf[y_at:y_at + 63] = y0
    y, out = buf[y_at:y_at + 63], buf[out_at:out_at + 63]
    if ok:
        assert draw_probes.fast_log(y, out=out) is out
        assert torch.equal(out, draws.fast_log(y0))
    else:
        before = buf.clone()
        with pytest.raises(ValueError, match="out overlaps y"):
            draw_probes.fast_log(y, out=out)
        assert torch.equal(buf, before)
    assert not draw_probes.fast_log.launches


def test_probe_device_is_resolved_once_and_cuda_raises(monkeypatch):
    """The probes resolve a device argument once (``resolve_device``) and
    keep it with its card index (-1: the current card); ``device='cuda'``
    with no card raises every time, and nothing is kept for it."""
    from rwm_pt_tpu_torch.kernels import draw_probes
    monkeypatch.setattr(draw_probes, "_DEVICES", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert draw_probes._device("cpu") == (torch.device("cpu"), -1)
    assert draw_probes._device("cpu") is draw_probes._DEVICES["cpu"]
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cuda"):
            draw_probes.draw_normals("bm", 1, 64, device="cuda")
    assert "cuda" not in draw_probes._DEVICES
    with pytest.raises(ValueError, match="seed must be non-negative"):
        draw_probes.draw_normals("bm", -1, 64, device="cpu")


def test_draw_libraries_are_named_and_flagged():
    """Each forced draw has a library of its own for Normal and
    UniformRadius (Laplace draws no normals), built with its
    -DRWM_PT_NORMAL code; the probe kernels are one library without kind
    or bucket, hashed over their own source."""
    from rwm_pt_tpu_torch.kernels import _build
    for impl, (suffix, code) in _build.DRAWS.items():
        for src in ("fused_pt", "fused_rwm"):
            name = _build.library(src, "UniformRadius", impl)
            assert name == f"{src}_uniform_radius{suffix}"
            flags = _build._flags(_build.lib_name(name, "rosenbrock", 30))
            assert f"-DRWM_PT_NORMAL={code}" in flags
            assert _build.library(src, "Laplace", impl) == f"{src}_laplace"
    assert set(_build.DRAWS) == set(draws.NORMAL_IMPLS)
    assert len(_build.VARIANTS) == 2 * (2 * len(_build.DRAWS) + 1)
    assert _build._flags(_build.PROBES) == _build.NVCC_FLAGS
    assert _build._source(_build.PROBES) == "draw_probes"
    assert _build._lib_path(_build.PROBES).name.startswith("libdraw_probes-")
    with pytest.raises(ValueError, match="unknown normal draw"):
        _build.library("fused_pt", "Normal", "ziggurat")
