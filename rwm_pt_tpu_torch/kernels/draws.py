"""Counter-based random draws of the fused samplers, in plain PyTorch.

Replaces the TPU hardware PRNG helpers of ``rwm_pt_tpu.kernels.pallas_rwm``
(``_uniform``, ``_erfinv_giles``, ``_normal_icdf``, and the increments
``_laplace`` and ``_uniform_ball``) with Philox4x32-10 (Salmon et al.,
SC'11, "Parallel random numbers: as easy as 1, 2, 3").  The CUDA kernels
(``csrc/philox.cuh``, ``csrc/draws.cuh``) compute the same words, so on the
card a plain run and a kernel run of one seed consume one stream.

Slot layout (the one definition; the kernels match it)
------------------------------------------------------
* key     = (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF)
* counter = (k, replica, rung, abs_step) as four 32-bit words, where
  ``abs_step = step0 + s + 1`` is the 1-based absolute step (``step0`` the
  state's step count when the launch starts, ``s`` the step within it), so
  a resumed segment continues the stream an uninterrupted run would draw;
* one Philox call gives the four words of block ``k``; word ``w`` of block
  ``k`` is slot ``j = 4k + w`` of that (replica, rung, step);
* slots ``0 .. d-1``: the increment words, one per coordinate: standard
  normals (ICDF draw below) for ``Normal`` and ``UniformRadius`` (the
  ball's direction), uniforms for ``Laplace``;
* slot ``d``: the MH accept uniform;
* slot ``d+1``: the swap uniform of pair (rung, rung+1), PT only, rungs
  ``0 .. T-2``, read on swap steps only;
* slot ``d+2``: the radius uniform of ``UniformRadius``, read by that
  proposal only.

RWM uses the same layout at ``rung = 0`` and never reads slot ``d+1``.  A
``Normal`` run reads exactly the words it read before slot ``d+2`` existed.

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


PROPOSAL_KINDS = ("Normal", "Laplace", "UniformRadius")
LAPLACE_CLAMP = -0.999999    # laplace.py:64-67 of the reference


def laplace_increment(u: torch.Tensor, scale) -> torch.Tensor:
    """Laplace increments from U[0,1) words ``u`` by the reference's inverse
    CDF, exactly ``pallas_rwm.py::_laplace``'s arithmetic: ``v = u - 0.5``,
    ``-scale * sign(v) * log1p(max(-2|v|, -0.999999))``.  ``sign(0) = 0``,
    so ``u = 0.5`` gives a zero increment; ``u = 0`` hits the clamp."""
    v = u - 0.5
    clamped = torch.clamp_min(-2.0 * torch.abs(v), LAPLACE_CLAMP)
    return -scale * torch.sign(v) * torch.log1p(clamped)


def uniform_ball_increment(normals: torch.Tensor, u_radius: torch.Tensor,
                           radius) -> torch.Tensor:
    """Uniform increments in the ``radius``-ball, exactly
    ``pallas_rwm.py::_uniform_ball``'s arithmetic: the direction
    ``normals / max(||normals||, 1e-12)`` (norm over axis 0) times
    ``radius * exp(log(U) / d)``, so ``U = 0`` gives 0.  ``normals``
    ``(d, *B)``, ``u_radius`` ``(*B)``, ``radius`` broadcastable to
    ``(*B)``."""
    d = normals.shape[0]
    norms = torch.sqrt(torch.sum(normals * normals, dim=0, keepdim=True))
    dirs = normals / torch.clamp_min(norms, 1e-12)
    return dirs * (radius * torch.exp(torch.log(u_radius) * (1.0 / d)))


def increment(kind: str, inc, u_rad, scale):
    """Proposal increment of ``kind`` from one step's draws (``inc`` and
    ``u_rad`` of :func:`step_draws`) and its effective scale: the Normal
    std, the UniformRadius radius (both broadcastable to the batch axes) or
    the Laplace scale ``(d, ...)``, broadcastable to ``inc``."""
    if kind == "Normal":
        return inc * scale
    if kind == "Laplace":
        return laplace_increment(inc, scale)
    return uniform_ball_increment(inc, u_rad, scale)


def n_records(total: int, record_every) -> int:
    """Trace entries of a recorded launch of ``total`` steps: one after
    every ``record_every``-th step; trailing steps are run, not recorded."""
    if not record_every:
        return 0
    if record_every < 1 or record_every > total:
        raise ValueError("record_every exceeds the total step count")
    return total // record_every


def step_draws(key: tuple[int, int], abs_step: int, n_rungs: int, dim: int,
               n_chains: int, device, swap: bool = True,
               kind: str = "Normal"):
    """One step's draws: ``(inc, u_mh, u_swap, u_radius)``.  ``inc`` is
    ``(T, d, C)``: normals for ``Normal`` and ``UniformRadius``, uniforms
    for ``Laplace``; MH uniforms ``(T, C)``; with ``swap``, swap uniforms
    ``(T, C)`` (row ``t`` serves pair ``(t, t+1)``; the last row is unused),
    else None; for ``UniformRadius`` the radius uniforms ``(T, C)`` (slot
    ``d+2``), else None."""
    if kind not in PROPOSAL_KINDS:
        raise ValueError(f"unknown proposal kind {kind!r}")
    n_slots = dim + 3 if kind == "UniformRadius" else (
        dim + 2 if swap else dim + 1)
    words = slot_words(key, abs_step, n_rungs, n_slots, n_chains, device)
    inc = uniform_from_bits(words[:, :dim])
    if kind != "Laplace":
        inc = normal_icdf(inc)
    u_mh = uniform_from_bits(words[:, dim])
    u_swap = uniform_from_bits(words[:, dim + 1]) if swap else None
    u_rad = (uniform_from_bits(words[:, dim + 2])
             if kind == "UniformRadius" else None)
    return inc, u_mh, u_swap, u_rad
