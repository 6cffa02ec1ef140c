"""The port's counter-based draws (rwm_pt_tpu_torch/kernels/draws.py):
Philox4x32-10 against Random123's known answers, the Giles erfinv against
the JAX package's, the ICDF normal's distribution, the slot layout of the
three proposals, and the Laplace and uniform-ball increments against
pallas_rwm.py's own on the same uniforms and normals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
