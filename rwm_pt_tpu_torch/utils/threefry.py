"""``jax.random.uniform(jax.random.key(seed), (n,), minval, maxval)`` bit
for bit, in numpy.

The JAX package draws the default coordinate scalings of its Scaled
targets (``ScaledMultivariateNormal``, ``ThreeMixture`` and ``RoughCarpet``
with ``scaling=True``) from that call.  The port keeps its own copy of the
recipe so that the same seed builds the same target without importing JAX:

* Threefry-2x32 with 20 rounds (Salmon et al., SC'11) under the key
  ``(0, seed & 0xFFFFFFFF)`` (JAX's key of an integer seed with 64-bit
  types off, its default), on the counters ``(0, i)``;
* the random word of element ``i`` is ``out0 ^ out1``;
* ``f = bitcast((bits >> 9) | 0x3F800000) - 1`` in ``[0, 1)``;
* ``max(lo, f * (hi - lo) + lo)``, where ``hi - lo`` is a float32
  difference and the affine map is rounded once to float32, as the fused
  multiply-add of XLA's CPU backend rounds it.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the uint32 counter words ``x0, x1``
    under ``key = (k0, k1)``; returns the two output words."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ _PARITY)
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _round_f32(q: Fraction) -> np.float32:
    """``q`` rounded once to the nearest float32 (ties to even)."""
    c = np.float32(float(q))
    best = None
    for v in (np.nextafter(c, np.float32(-np.inf)), c,
              np.nextafter(c, np.float32(np.inf))):
        err = abs(Fraction(float(v)) - q)
        if best is None or err < best[0] or (
                err == best[0] and int(v.view(np.uint32)) % 2 == 0):
            best = (err, v)
    return best[1]


def uniform(seed: int, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``(n,)`` float32 uniforms equal to ``jax.random.uniform(
    jax.random.key(seed), (n,), minval=minval, maxval=maxval)``."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("seed must be non-negative")
    key = (0, seed & 0xFFFFFFFF)
    o0, o1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = (o0 ^ o1) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = Fraction(float(hi - lo))
    out = np.array([_round_f32(Fraction(float(v)) * span + Fraction(float(lo)))
                    for v in f], np.float32)
    return np.maximum(lo, out)
