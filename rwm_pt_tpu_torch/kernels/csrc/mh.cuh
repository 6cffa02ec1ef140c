// One Metropolis-Hastings move of one (replica, rung) state held in
// registers, shared by fused_pt.cu and fused_rwm.cu: the MH body of
// rwm_pt_tpu/kernels/pallas_pt.py::_pt_body_fn (:57-68) and
// pallas_rwm.py::_make_kernel (:293-312), with the three increments of
// pallas_rwm.py (_normal, _laplace, _uniform_ball):
//   Normal         eps_i = N_i * scale
//   Laplace        eps_i = laplace_increment(U_i, lap[i]) (slots 0..d-1)
//   UniformRadius  eps = N / max(||N||, 1e-12) * scale * exp(log(U) / d)
//                  (U in slot d+2)
//   y = x + eps, r = beta (lp(y) - lp(x)), accept if r > 0 or u < exp(r)
//   (u in slot d; NaN rejects, and so does lp(x) = lp(y) = -inf).
// The normals N (Normal, UniformRadius) come from the draw DRAW:
//   DRAW_ICDF  N_i = normal_icdf(U_i), U_i in slot i (i < d); the draw
//              study's DRAW_ICDF_FASTLOG, DRAW_LAX_ERFINV and
//              DRAW_FAKE_UNIFORM read the same slots, N_i =
//              icdf_layout_normal<DRAW>(U_i) (csrc/draws.cuh);
//   DRAW_BM    Box-Muller (pallas_rwm.py::_normal_bm :53-64): pair
//              k < h = ceil(d/2) draws u1 from slot k (clamped at 1e-7) and
//              u2 from slot h + k (slot d+3 for the last pair of an odd d),
//              r = sqrt(-2 log u1), theta = 2 pi u2 (rounded), and gives
//              r cos theta to coordinate k and r sin theta to coordinate
//              k + h (kernels/draws.py::bm_slots).
// Box-Muller's second half lands at a runtime offset h, so the sines wait
// in a small per-thread array (local memory) until the coordinates k + h,
// which are compile-time indices again, read them back; x[] and p[] stay
// in registers.
// The uniform ball's direction stays in p[]: first the normals, then the
// norm, then x + n/||n|| * r; no third array of DMAX floats.  Its MH word
// (slot d) is read before the radius word (slot d+2), so Philox blocks are
// taken in order and none is computed twice.
// On return x holds the new state, p the state before the move, lp the new
// log-density and `jump` = sum_i (x_new_i - x_old_i)^2 (0 on reject).
// Each increment product is rounded on its own (__fmul_rn), as the plain
// version rounds it, instead of being contracted into the add.
#pragma once
#include "draws.cuh"
#include "philox.cuh"
#include "targets.cuh"

// Fill p[0..d-1] with Box-Muller normals; leaves the block of the last
// word drawn in (blk, cur_k).
template <int DMAX>
__device__ __forceinline__ void bm_normals(float (&p)[DMAX], int d,
                                           int replica, int rung,
                                           int abs_step, uint32_t key0,
                                           uint32_t key1, uint4& blk,
                                           int& cur_k) {
  constexpr int HMAX = (DMAX + 1) / 2;
  const int h = (d + 1) >> 1;
  float sn[HMAX];
  uint4 blk2;
  int cur2 = -1;
#pragma unroll
  for (int k = 0; k < HMAX; ++k) {
    if (k < h) {
      const float u1 = fmaxf(uniform_from_bits(slot_word(
          k, blk, cur_k, replica, rung, abs_step, key0, key1)), 1e-7f);
      const int j2 = h + k < d ? h + k : d + 3;
      const float u2 = uniform_from_bits(slot_word(
          j2, blk2, cur2, replica, rung, abs_step, key0, key1));
      float r, sn_k, cs_k;
      box_muller(u1, u2, r, sn_k, cs_k);
      p[k] = cs_k;
      sn[k] = sn_k;
    }
  }
#pragma unroll
  for (int i = 1; i < DMAX; ++i)
    if (i >= h && i < d) p[i] = sn[i - h];
  blk = blk2;
  cur_k = cur2;
}

template <int KIND, int PROP, int DRAW, int DMAX>
__device__ __forceinline__ bool mh_move(
    float (&x)[DMAX], float (&p)[DMAX], float& lp, float& jump, int d,
    const float* __restrict__ params, float scale,
    const float* __restrict__ lap, float inv_d, float beta, int replica,
    int rung, int abs_step, uint32_t key0, uint32_t key1, uint4& blk,
    int& cur_k) {
  if constexpr (PROP != PROPOSAL_LAPLACE && DRAW == DRAW_BM) {
    bm_normals<DMAX>(p, d, replica, rung, abs_step, key0, key1, blk, cur_k);
    if constexpr (PROP == PROPOSAL_NORMAL) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) p[i] = x[i] + __fmul_rn(p[i], scale);
    }
  } else {
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        if ((i & 3) == 0) {
          blk = philox_block(i >> 2, replica, rung, abs_step, key0, key1);
          cur_k = i >> 2;
        }
        const float u = uniform_from_bits(philox_word(blk, i & 3));
        if constexpr (PROP == PROPOSAL_NORMAL) {
          p[i] = x[i] + __fmul_rn(icdf_layout_normal<DRAW>(u), scale);
        } else if constexpr (PROP == PROPOSAL_LAPLACE) {
          p[i] = x[i] + laplace_increment(u, lap[i]);
        } else {
          p[i] = icdf_layout_normal<DRAW>(u);
        }
      }
    }
  }
  uint32_t w_mh = 0;
  if constexpr (PROP == PROPOSAL_UNIFORM_RADIUS) {
    w_mh = slot_word(d, blk, cur_k, replica, rung, abs_step, key0, key1);
    const float u_r = uniform_from_bits(
        slot_word(d + 2, blk, cur_k, replica, rung, abs_step, key0, key1));
    const float r = scale * expf(logf(u_r) * inv_d);
    float nrm2 = 0.0f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) nrm2 += p[i] * p[i];
    const float den = fmaxf(sqrtf(nrm2), 1e-12f);
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) p[i] = x[i] + __fmul_rn(p[i] / den, r);
  }
  const float lp_prop = log_density<KIND, DMAX>(p, d, params);
  const float log_ratio = beta * (lp_prop - lp);
  if constexpr (PROP != PROPOSAL_UNIFORM_RADIUS)
    w_mh = slot_word(d, blk, cur_k, replica, rung, abs_step, key0, key1);
  const float u = uniform_from_bits(w_mh);
  const bool accept = (log_ratio > 0.0f) || (u < expf(log_ratio));
  jump = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i < d) {
      const float old = x[i];
      const float nx = accept ? p[i] : old;
      const float dd = nx - old;
      jump += dd * dd;
      x[i] = nx;
      p[i] = old;
    }
  }
  if (accept) lp = lp_prop;
  return accept;
}
