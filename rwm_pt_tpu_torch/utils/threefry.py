"""``jax.random``'s threefry streams bit for bit, in numpy: ``key``,
``split``, ``uniform``, ``normal`` and ``bernoulli`` of float32 under JAX's
partitionable threefry (``jax_threefry_partitionable``, on by default
since JAX 0.5).

The JAX package draws the default coordinate scalings of its Scaled
targets (``ScaledMultivariateNormal``, ``ThreeMixture`` and ``RoughCarpet``
with ``scaling=True``) from ``uniform`` and SuperFunnel's synthetic
dataset from ``split``, ``normal`` and ``bernoulli``.  The port keeps its
own copy of the recipe so that the same seed builds the same target
without importing JAX:

* Threefry-2x32 with 20 rounds (Salmon et al., SC'11); the key of an
  integer seed is ``(0, seed & 0xFFFFFFFF)`` (JAX's, with 64-bit types
  off, its default);
* element ``i`` of a draw (row-major index) takes the counters ``(0, i)``,
  its random word is ``out0 ^ out1``; ``split(key, n)``'s key ``i`` is the
  pair ``(out0, out1)`` of the counters ``(0, i)``;
* ``uniform``: ``f = bitcast((bits >> 9) | 0x3F800000) - 1`` in ``[0,
  1)``, then ``max(lo, f * (hi - lo) + lo)``, where ``hi - lo`` is a
  float32 difference and the affine map is rounded once to float32, as the
  fused multiply-add of XLA's CPU backend rounds it;
* ``normal``: ``sqrt(2) * erf_inv(u)`` of ``u = uniform(key, shape,
  nextafter(-1, 0), 1)`` (``jax._src.random._normal_real``), with
  :func:`erf_inv` the float32 ErfInv that XLA's CPU backend runs;
* ``bernoulli``: ``uniform(key, shape) < p``.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
f32 = np.float32


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


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s two words."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("seed must be non-negative")
    return (0, seed & 0xFFFFFFFF)


def _as_key(k) -> tuple[int, int]:
    return key(k) if isinstance(k, (int, np.integer)) else (int(k[0]),
                                                           int(k[1]))


def _counters(k, n: int):
    return threefry2x32(_as_key(k), np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def split(k, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(k, num)``'s keys (``k`` a key or a seed)."""
    o0, o1 = _counters(k, num)
    return [(int(a), int(b)) for a, b in zip(o0, o1)]


def _fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 arrays rounded once to float32.  The
    product is exact in float64; the sum's float64 rounding error ``e``
    (TwoSum) decides the one case where rounding twice could differ, a
    float64 sum that lies on a float32 midpoint."""
    a, b, c = (np.asarray(v, f32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    e = (p - bp) + (c - (s - bp))
    r = s.astype(f32)
    r64 = r.astype(np.float64)
    up = r64 < s                       # the other float32 neighbour of s
    nb = np.where(up, np.nextafter(r, f32(np.inf)),
                  np.nextafter(r, f32(-np.inf)))
    tie = (s == (r64 + nb.astype(np.float64)) / 2) & (e != 0)
    return np.where(tie & ((e > 0) == up), nb, r).astype(f32)


def uniform(k, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 uniforms equal to ``jax.random.uniform(k, shape,
    minval=minval, maxval=maxval)`` (``k`` a key or a seed; ``shape`` a
    tuple or an int)."""
    shape = (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    o0, o1 = _counters(k, n)
    bits = (o0 ^ o1) >> np.uint32(9) | np.uint32(0x3F800000)
    u = bits.view(f32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, _fma32(u, hi - lo, lo)).reshape(shape)


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"), the
# coefficients of w < 5 and of w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA CPU's log1p below |x| < sqrt(2) - 1: Cephes' rational function,
# highest degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA CPU's float32 log (Cephes' logf)
_LOG_P = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def _log(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 log of positive finite ``x`` (Cephes' logf, each
    multiply-add contracted into one rounding as LLVM contracts it)."""
    t = np.maximum(x, np.uint32(0x00800000).view(f32))
    bits = t.view(np.uint32)
    e = f32(1.0) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F
                    ).astype(f32)
    t = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f32)
    small = t < f32(0.707106781186547524)
    t = (t - f32(1.0)) + np.where(small, t, f32(0.0))
    e = e - np.where(small, f32(1.0), f32(0.0))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma32(_fma32(t, p[0], p[1]), t, p[2])
    y1 = _fma32(_fma32(t, p[3], p[4]), t, p[5])
    y2 = _fma32(_fma32(t, p[6], p[7]), t, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, f32(-2.12194440e-4) * e)
    t = _fma32(f32(-0.5), x2, t) + y
    return _fma32(f32(0.693359375), e, t)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma32(p, x, f32(c))
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA CPU's float32 log1p of ``x`` > -1."""
    x2 = x * x
    small = x + _fma32(f32(-0.5), x2, (x * x2) * (
        _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)))
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _log(np.maximum(x + f32(1.0), np.finfo(f32).tiny))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


def erf_inv(x) -> np.ndarray:
    """``lax.erf_inv`` of float32 ``x`` in (-1, 1) as XLA's CPU backend
    computes it (subnormal inputs flushed to zero): w = -log1p(-x^2);
    below w = 5 Giles' polynomial in w - 2.5, else in sqrt(w) - 3, by
    Horner's rule with each step one fused multiply-add; times x."""
    x = np.asarray(x, f32)
    if np.any(np.abs(x) >= 1):
        raise ValueError("erf_inv takes |x| < 1")
    # XLA's CPU backend flushes subnormals to zero
    x = np.where(np.abs(x) < np.finfo(f32).tiny, f32(0.0) * x, x)
    w = -_log1p(-x * x)
    lt = w < f32(5.0)
    z = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma32(p, z, np.where(lt, f32(a), f32(b)))
    return (p * x).astype(f32)


_NORMAL_LO = np.nextafter(f32(-1.0), f32(0.0))


def normal(k, shape) -> np.ndarray:
    """float32 standard normals equal to ``jax.random.normal(k, shape)``."""
    u = uniform(k, shape, _NORMAL_LO, 1.0)
    return (f32(np.sqrt(2)) * erf_inv(u)).astype(f32)


def bernoulli(k, p) -> np.ndarray:
    """``jax.random.bernoulli(k, p)`` of a float32 array ``p``: booleans
    of its shape."""
    p = np.asarray(p, f32)
    return uniform(k, p.shape) < p
