// Uniform, inverse-CDF and Box-Muller normal draws and the Laplace
// increment, the same scheme as rwm_pt_tpu_torch/kernels/draws.py
// (uniform_from_bits, erfinv_giles, normal_icdf, normal_bm,
// laplace_increment), replacing rwm_pt_tpu/kernels/pallas_rwm.py::_uniform,
// _erfinv_giles, _normal_icdf, _normal_bm and _laplace.  Per ICDF normal:
// 1 logf + 1 sqrtf + 16 FMA of Giles' two polynomials + a select; per
// Box-Muller pair (two normals): 1 logf + 1 sqrtf + 1 sincosf.  Built
// without --use_fast_math: logf, log1pf, expf, sqrtf and sincosf stay
// IEEE-accurate so the draws agree with the plain version (and logf(0) =
// -inf, expf(-inf) = 0 hold for the uniform ball).
#pragma once
#include <stdint.h>

// Proposal kinds; each kernel library is built for one (-DRWM_PT_PROPOSAL).
#define PROPOSAL_NORMAL 0
#define PROPOSAL_LAPLACE 1
#define PROPOSAL_UNIFORM_RADIUS 2
// Normal draws; each library is built for one (-DRWM_PT_NORMAL).
#define DRAW_ICDF 0
#define DRAW_BM 1

// top 24 bits, logical shift (uint32), times 2^-24: U[0,1)
__device__ __forceinline__ float uniform_from_bits(uint32_t w) {
  return (float)(w >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float erfinv_giles(float x) {
  const float w = -logf(fmaxf((1.0f - x) * (1.0f + x), 1e-37f));
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
  return x * (w < 5.0f ? pc : pt);
}

// sqrt(2) erfinv(2u - 1 + 2^-24)
__device__ __forceinline__ float normal_icdf(float u) {
  return 1.41421356237309515f *
         erfinv_giles(2.0f * u - 1.0f + (1.0f / 16777216.0f));
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
__device__ __forceinline__ void box_muller(float u1, float u2, float& r,
                                           float& rs, float& rc) {
  r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(__fmul_rn(6.28318530717958648f, u2), &s, &c);
  rs = __fmul_rn(r, s);
  rc = __fmul_rn(r, c);
}
