"""Counter-based random draws of the fused samplers, in plain PyTorch.

Replaces the TPU hardware PRNG helpers of ``rwm_pt_tpu.kernels.pallas_rwm``
(``_uniform``, ``_erfinv_giles``, ``_normal_icdf``) with Philox4x32-10
(Salmon et al., SC'11, "Parallel random numbers: as easy as 1, 2, 3").  The
CUDA kernels (``csrc/philox.cuh``, ``csrc/draws.cuh``) compute the same
words, so on the card a plain run and a kernel run of one seed consume one
stream.

Slot layout (the one definition; the kernels match it)
------------------------------------------------------
* key     = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
* counter = (k, replica, rung, abs_step) as four 32-bit words, where
  ``abs_step = step0 + s + 1`` is the 1-based absolute step (``step0`` the
  state's step count when the launch starts, ``s`` the step within it), so
  a resumed segment continues the stream an uninterrupted run would draw;
* one Philox call gives the four words of block ``k``; word ``w`` of block
  ``k`` is slot ``j = 4k + w`` of that (replica, rung, step);
* slots ``0 .. d-1``: the standard normals of the proposal increment, one
  per coordinate (ICDF draw below);
* slot ``d``: the MH accept uniform;
* slot ``d+1``: the swap uniform of pair (rung, rung+1), PT only, rungs
  ``0 .. T-2``, read on swap steps only.

RWM uses the same layout at ``rung = 0`` and never reads slot ``d+1``.

Uniforms are the top 24 bits of a word times 2^-24 -- a *logical* shift
(``pallas_rwm.py:44-46``: a sign-extending shift of an int32 view makes
half of the "uniforms" negative and auto-accepts every proposal).  Words are
held here as non-negative int64, so ``>>`` is logical; the kernels use
``uint32``.
"""
from __future__ import annotations

import math

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF

# Giles (2010), "Approximating the erfinv function": single-precision
# polynomials, central branch (w < 5) and tail branch (pallas_rwm.py:70-75).
GILES_P1 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
            -4.39150654e-06, 0.00021858087, -0.00125372503,
            -0.00417768164, 0.246640727, 1.50140941)
GILES_P2 = (-0.000200214257, 0.000100950558, 0.00134934322,
            -0.00367342844, 0.00573950773, -0.0076224613,
            0.00943887047, 1.00167406, 2.83297682)
SQRT2 = math.sqrt(2.0)
_TWO_M24 = 1.0 / (1 << 24)


def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a``
    and 32-bit words ``b`` held in int64.  The full product can exceed
    2^63 (0xD2511F53 * 0xFFFFFFFF), so it is formed from 16-bit limbs of
    ``b``: p = a * (b >> 16) and q = a * (b & 0xFFFF) are both < 2^48."""
    p = a * (b >> 16)
    q = a * (b & 0xFFFF)
    hi = (p + (q >> 16)) >> 16
    lo = (((p & 0xFFFF) << 16) + q) & _MASK32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox4x32-``rounds`` of counter words ``c0..c3`` (int64 tensors of
    32-bit values, broadcastable) under key ``(k0, k1)``.  Returns the four
    output words as int64 tensors."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> tuple[int, int]:
    """Philox key words of a non-negative integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("seed must be non-negative")
    return seed & _MASK32, (seed >> 32) & _MASK32


def resolve_seed(seed) -> int:
    """Integer seed from an ``int`` or a ``torch.Generator`` (one draw)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=seed,
                                 device=seed.device).item())
    return int(seed)


def uniform_from_bits(words: torch.Tensor) -> torch.Tensor:
    """U[0,1) in float32: top 24 bits of each 32-bit word times 2^-24."""
    return (words >> 8).to(torch.float32) * _TWO_M24


def erfinv_giles(x: torch.Tensor) -> torch.Tensor:
    """Giles' single-precision erfinv, with the log argument clamped at
    1e-37 (pallas_rwm.py:78-87)."""
    w = -torch.log(torch.clamp_min((1.0 - x) * (1.0 + x), 1e-37))
    wc = w - 2.5
    wt = torch.sqrt(w) - 3.0
    pc = torch.full_like(x, GILES_P1[0])
    pt = torch.full_like(x, GILES_P2[0])
    for c1, c2 in zip(GILES_P1[1:], GILES_P2[1:]):
        pc = pc * wc + c1
        pt = pt * wt + c2
    return x * torch.where(w < 5.0, pc, pt)


def normal_icdf(u: torch.Tensor) -> torch.Tensor:
    """N(0,1) from U[0,1): sqrt(2) erfinv(2u - 1 + 2^-24)."""
    return SQRT2 * erfinv_giles(2.0 * u - 1.0 + _TWO_M24)


def slot_words(key: tuple[int, int], abs_step: int, n_rungs: int,
               n_slots: int, n_chains: int, device) -> torch.Tensor:
    """Random words of slots ``0 .. n_slots-1`` for every (rung, replica)
    at one absolute step: int64 ``(n_rungs, n_slots, n_chains)``."""
    n_blk = -(-n_slots // 4)
    kk = torch.arange(n_blk, dtype=torch.int64, device=device)
    k_ctr = kk.reshape(1, n_blk, 1)
    c_ctr = torch.arange(n_chains, dtype=torch.int64,
                         device=device).reshape(1, 1, n_chains)
    t_ctr = torch.arange(n_rungs, dtype=torch.int64,
                         device=device).reshape(n_rungs, 1, 1)
    s_ctr = torch.tensor(abs_step & _MASK32, dtype=torch.int64,
                         device=device)
    words = torch.stack(philox4x32(k_ctr, c_ctr, t_ctr, s_ctr, *key),
                        dim=2)                       # (T, n_blk, 4, C)
    return words.reshape(n_rungs, n_blk * 4, n_chains)[:, :n_slots]


def step_draws(key: tuple[int, int], abs_step: int, n_rungs: int, dim: int,
               n_chains: int, device, swap: bool = True):
    """One step's draws: normals ``(T, d, C)``, MH uniforms ``(T, C)`` and,
    with ``swap``, swap uniforms ``(T, C)`` (row ``t`` serves pair
    ``(t, t+1)``; the last row is unused)."""
    words = slot_words(key, abs_step, n_rungs, dim + 2 if swap else dim + 1,
                       n_chains, device)
    normals = normal_icdf(uniform_from_bits(words[:, :dim]))
    u_mh = uniform_from_bits(words[:, dim])
    u_swap = uniform_from_bits(words[:, dim + 1]) if swap else None
    return normals, u_mh, u_swap
