// Uniform, inverse-CDF and Box-Muller normal draws, the draw study's
// bit-trick-log, library-erfinv and fake-uniform draws, and the Laplace
// increment, the same scheme as rwm_pt_tpu_torch/kernels/draws.py
// (uniform_from_bits, erfinv_giles, normal_icdf, normal_bm, fast_log,
// normal_icdf_fastlog, normal_laxerfinv, normal_fake_uniform,
// laplace_increment), replacing rwm_pt_tpu/kernels/pallas_rwm.py::_uniform,
// _erfinv_giles, _normal_icdf, _normal_bm, _fast_log, _normal_icdf_fastlog,
// _normal_laxerfinv, _normal_fake_uniform and _laplace.  Per ICDF normal:
// 1 logf + 1 sqrtf + 16 FMA of Giles' two polynomials + a select; per
// Box-Muller pair (two normals): 1 logf + 1 sqrtf + 1 sincosf; the
// bit-trick-log ICDF normal trades the logf for integer bit work and 8
// more multiply-adds; the library-erfinv normal is one CUDA erfinvf (a
// math function inside this kernel, as lax.erf_inv is whatever Mosaic
// lowers it to); the fake uniform is one multiply and is NOT a normal.
// Built without --use_fast_math: logf, log1pf, expf, sqrtf, sincosf and
// erfinvf stay IEEE-accurate so the draws agree with the plain version (and
// logf(0) = -inf, expf(-inf) = 0 hold for the uniform ball).
#pragma once
#include <stdint.h>

// Proposal kinds; each kernel library is built for one (-DRWM_PT_PROPOSAL).
#define PROPOSAL_NORMAL 0
#define PROPOSAL_LAPLACE 1
#define PROPOSAL_UNIFORM_RADIUS 2
// Normal draws; each library is built for one (-DRWM_PT_NORMAL).
#define DRAW_ICDF 0
#define DRAW_BM 1
#define DRAW_ICDF_FASTLOG 2
#define DRAW_LAX_ERFINV 3
#define DRAW_FAKE_UNIFORM 4

// top 24 bits, logical shift (uint32), times 2^-24: U[0,1)
__device__ __forceinline__ float uniform_from_bits(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

// Giles' polynomial of w = -log((1-x)(1+x)): erfinv(x) / x
__device__ __forceinline__ float giles_poly(float w) {
  const float wc = w - 2.5f;
  const float wt = sqrtf(w) - 3.0f;
  float pc = 2.81022636e-08f;
  pc = pc * wc + 3.43273939e-07f;
  pc = pc * wc + -3.5233877e-06f;
  pc = pc * wc + -4.39150654e-06f;
  pc = pc * wc + 0.00021858087f;
  pc = pc * wc + -0.00125372503f;
  pc = pc * wc + -0.00417768164f;
  pc = pc * wc + 0.246640727f;
  pc = pc * wc + 1.50140941f;
  float pt = -0.000200214257f;
  pt = pt * wt + 0.000100950558f;
  pt = pt * wt + 0.00134934322f;
  pt = pt * wt + -0.00367342844f;
  pt = pt * wt + 0.00573950773f;
  pt = pt * wt + -0.0076224613f;
  pt = pt * wt + 0.00943887047f;
  pt = pt * wt + 1.00167406f;
  pt = pt * wt + 2.83297682f;
  return w < 5.0f ? pc : pt;
}

__device__ __forceinline__ float erfinv_giles(float x) {
  return x * giles_poly(-logf(fmaxf((1.0f - x) * (1.0f + x), 1e-37f)));
}

// sqrt(2) erfinv(2u - 1 + 2^-24)
__device__ __forceinline__ float normal_icdf(float u) {
  return 1.41421356237309515f *
         erfinv_giles(2.0f * u - 1.0f + (1.0f / 16777216.0f));
}

// log(y) of a finite y > 0 by the Cephes logf scheme
// (pallas_rwm.py::_fast_log): y = m 2^e with m in [sqrt(1/2), sqrt(2)),
// log y = e ln2 + log(1 + f), f = m - 1, from the exponent bits and a
// degree-8 polynomial in f, highest power first.  Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn), in the plain version's order,
// so the card's result is the plain version's.
__device__ __forceinline__ float fast_log(float y) {
  const int bits = __float_as_int(y);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  if (m > 1.41421356f) {
    m = m * 0.5f;   // exact
    e += 1;
  }
  const float f = m - 1.0f;
  float p = 7.0376836292e-2f;
  p = __fadd_rn(__fmul_rn(p, f), -1.1514610310e-1f);
  p = __fadd_rn(__fmul_rn(p, f), 1.1676998740e-1f);
  p = __fadd_rn(__fmul_rn(p, f), -1.2420140846e-1f);
  p = __fadd_rn(__fmul_rn(p, f), 1.4249322787e-1f);
  p = __fadd_rn(__fmul_rn(p, f), -1.6668057665e-1f);
  p = __fadd_rn(__fmul_rn(p, f), 2.0000714765e-1f);
  p = __fadd_rn(__fmul_rn(p, f), -2.4999993993e-1f);
  p = __fadd_rn(__fmul_rn(p, f), 3.3333331174e-1f);
  const float f2 = __fmul_rn(f, f);
  // (f2 f) p - 0.5 f2 + f + e ln2, left to right
  float r = __fmul_rn(__fmul_rn(f2, f), p);
  r = __fsub_rn(r, __fmul_rn(0.5f, f2));
  r = __fadd_rn(r, f);
  return __fadd_rn(r, __fmul_rn((float)e, 0.693147180559945309f));
}

// the ICDF normal with fast_log in place of Giles' logf
// (pallas_rwm.py::_normal_icdf_fastlog): (sqrt(2) x) p(w)
__device__ __forceinline__ float normal_icdf_fastlog(float u) {
  const float x = 2.0f * u - 1.0f + (1.0f / 16777216.0f);
  const float w = -fast_log(fmaxf((1.0f - x) * (1.0f + x), 1e-37f));
  return __fmul_rn(__fmul_rn(1.41421356237309515f, x), giles_poly(w));
}

// sqrt(2) erfinvf(2u - 1 + 2^-24), CUDA's own single-precision erfinv
// (pallas_rwm.py::_normal_laxerfinv takes lax.erf_inv)
__device__ __forceinline__ float normal_erfinv(float u) {
  return 1.41421356237309515f *
         erfinvf(2.0f * u - 1.0f + (1.0f / 16777216.0f));
}

// NOT a normal: (u - 0.5) f32(sqrt(12)), the variance-matched uniform of
// pallas_rwm.py::_normal_fake_uniform, for timing a near-free draw only
__device__ __forceinline__ float normal_fake_uniform(float u) {
  return (u - 0.5f) * 3.46410155296325684f;
}

// normal i of the draws that read the ICDF slot layout, from the uniform
// of slot i (kernels/draws.py::ICDF_LAYOUT)
template <int DRAW>
__device__ __forceinline__ float icdf_layout_normal(float u) {
  if constexpr (DRAW == DRAW_ICDF_FASTLOG) {
    return normal_icdf_fastlog(u);
  } else if constexpr (DRAW == DRAW_LAX_ERFINV) {
    return normal_erfinv(u);
  } else if constexpr (DRAW == DRAW_FAKE_UNIFORM) {
    return normal_fake_uniform(u);
  } else {
    return normal_icdf(u);
  }
}

// Laplace increment from U[0,1): v = u - 0.5 (exact),
// -scale * sign(v) * log1p(max(-2|v|, -0.999999)); sign(0) = 0, so u = 0.5
// gives 0, and u = 0 hits the clamp.  -scale * sign(v) is exact; the product
// with log1p is rounded on its own, as the plain version rounds it.
__device__ __forceinline__ float laplace_increment(float u, float scale) {
  const float v = u - 0.5f;
  const float c = fmaxf(-2.0f * fabsf(v), -0.999999f);
  const float sg = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(-scale * sg, log1pf(c));
}

// One Box-Muller pair, pallas_rwm.py::_normal_bm's arithmetic: u1 already
// clamped at 1e-7, r = sqrt(-2 log u1), theta = 2 pi u2 rounded to f32;
// rs = r sin theta, rc = r cos theta, each product rounded on its own.
// theta lies in [0, 2 pi); the test around sincosf is the one sincosf
// makes before its Payne-Hanek reduction for |theta| >= 105615 (whose
// table is a 32-byte local array), so the compiler may drop that path.
__device__ __forceinline__ void box_muller(float u1, float u2, float& r,
                                           float& rs, float& rc) {
  r = sqrtf(-2.0f * logf(u1));
  const float theta = __fmul_rn(6.28318530717958648f, u2);
  float s = 0.0f, c = 1.0f;
  if (!(fabsf(theta) >= 105615.0f)) sincosf(theta, &s, &c);
  rs = __fmul_rn(r, s);
  rc = __fmul_rn(r, c);
}
