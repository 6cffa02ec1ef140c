"""The port's counter-based draws (rwm_pt_tpu_torch/kernels/draws.py):
Philox4x32-10 against Random123's known answers, the Giles erfinv against
the JAX package's, and the ICDF normal's distribution."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

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
    n, u, us = draws.step_draws(draws.seed_key(3), 1, 4, 6, 8, "cpu")
    assert n.shape == (4, 6, 8) and u.shape == (4, 8) and us.shape == (4, 8)
    n2, _, _ = draws.step_draws(draws.seed_key(3), 2, 4, 6, 8, "cpu")
    assert not torch.equal(n, n2)
    g = torch.Generator().manual_seed(0)
    assert draws.resolve_seed(g) == draws.resolve_seed(
        torch.Generator().manual_seed(0))
