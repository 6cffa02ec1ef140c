// One Metropolis-Hastings proposal and accept test of one (replica, rung)
// state, shared by fused_pt.cu and fused_rwm.cu: the MH body of
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
//
// State layout.  The current state x lives in a shared-memory slab, one
// row per thread: coordinate i of a thread's state is row[i], rows
// kRowPitch<DMAX> = DMAX + 4 words apart (a multiple of four that is 4 x an
// odd number, so the 16-byte accesses of a quarter-warp's 8 threads cover
// 32 distinct banks).  Rows are read and written four coordinates at a
// time (float4), at offsets fixed at compile time from one base address:
// no address arithmetic on the integer pipe that Philox already fills.
// Only the proposal y[DMAX] is held in registers (the target's
// log-density takes it there); that halves the registers a state costs
// and lets more warps share an SM.  mh_propose reads x from the slab and
// does not write it: the caller stores y on an accept once nothing needs
// the pre-move state any more (the PT swap sweep's cold-rung jump does).
// Box-Muller's sine of pair k belongs to coordinate k + h, an index known
// at run time only, so it waits in a shared-memory row of its own
// (kSinePitch<DMAX> = DMAX/2 + 1 words, odd, so a warp's 32 scalar
// accesses hit 32 banks) until coordinate i >= h reads word i - h: a
// runtime index into shared memory, where a register array would go to a
// local-memory stack frame.
// SuperFunnel (csrc/targets.cuh kind 12) reads the proposal's alphas and
// betas at run-time indices (group j, covariate k): a run-time index into
// y[] would put it on a stack frame, so state_log_density first writes y
// to the thread's stage row (kStagePitch<DMAX> = DMAX + 1 words, odd, so
// that a warp's 32 scalar accesses of one word hit 32 banks) and the
// log-density reads it there.  A build with the dataset's shape fixed
// (-DRWM_PT_SF_J, _K, _N, _UNROLL; csrc/targets.cuh::SuperFunnelFixed)
// reads y from the registers, takes no stage row, and its parameter
// pointer points at the kernel parameter that holds the dataset.
// The uniform ball's direction stays in y[]: first the normals, then the
// norm, then x + n/||n|| * r.  Its MH word (slot d) is read before the
// radius word (slot d+2), so Philox blocks are taken in order and none is
// computed twice.
// Each increment product is rounded on its own (__fmul_rn), as the plain
// version rounds it, instead of being contracted into the add.
#pragma once
#include "draws.cuh"
#include "philox.cuh"
#include "targets.cuh"

template <int DMAX>
constexpr int kRowPitch = DMAX + 4;
template <int DMAX>
constexpr int kSinePitch = DMAX / 2 + 1;
template <int DMAX>
constexpr int kStagePitch = DMAX + 1;
// Words of a thread's stage row for target kind KIND (SuperFunnel's alone)
template <int KIND, int DMAX>
constexpr int kStage = KIND == TARGET_SUPER_FUNNEL ? kStagePitch<DMAX> : 0;
#ifdef RWM_PT_SF_N
// the dataset of a build with SuperFunnel's shape fixed
using SuperFunnelBuild = SuperFunnelFixed<RWM_PT_SF_J, RWM_PT_SF_K,
                                          RWM_PT_SF_N, RWM_PT_SF_UNROLL>;
#endif

// The log-density of the state y (registers); SuperFunnel's through the
// thread's stage row
template <int KIND, int DMAX>
__device__ __forceinline__ float state_log_density(
    const float (&y)[DMAX], float* stage, int d,
    const float* __restrict__ p) {
  if constexpr (KIND == TARGET_SUPER_FUNNEL) {
#ifdef RWM_PT_SF_N
    // a fixed-shape build: p is the kernel parameter's dataset
    return super_funnel_log_density_fixed(
        y, reinterpret_cast<const SuperFunnelBuild*>(p));
#else
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) stage[i] = y[i];
    return super_funnel_log_density([stage](int i) { return stage[i]; }, d,
                                    p);
#endif
  } else {
    return log_density<KIND, DMAX>(y, d, p);
  }
}

__device__ __forceinline__ float quad_word(const float4& v, int w) {
  return w == 0 ? v.x : (w == 1 ? v.y : (w == 2 ? v.z : v.w));
}

// Words 4q..4q+3 of a state row (16-byte aligned).
__device__ __forceinline__ float4 row_quad(const float* row, int q) {
  return reinterpret_cast<const float4*>(row)[q];
}

// Fill y[0..d-1] with Box-Muller normals, the sines through the thread's
// shared-memory row sn; leaves the block of the last word drawn in
// (blk, cur_k).
template <int DMAX>
__device__ __forceinline__ void bm_normals(float (&y)[DMAX], float* sn,
                                           int d, int replica, int rung,
                                           int abs_step, uint32_t key0,
                                           uint32_t key1, uint4& blk,
                                           int& cur_k) {
  constexpr int HMAX = (DMAX + 1) / 2;
  const int h = (d + 1) >> 1;
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
      y[k] = cs_k;
      sn[k] = sn_k;
    }
  }
#pragma unroll
  for (int i = 1; i < DMAX; ++i)
    if (i >= h && i < d) y[i] = sn[i - h];
  blk = blk2;
  cur_k = cur2;
}

// y[0..d-1] = the state row (and the row's words up to the next multiple
// of four, which are never read as coordinates)
template <int DMAX>
__device__ __forceinline__ void load_row(float (&y)[DMAX], const float* row,
                                         int d) {
#pragma unroll
  for (int q = 0; q < DMAX / 4; ++q) {
    if (4 * q < d) {
      const float4 v = row_quad(row, q);
      y[4 * q] = v.x;
      y[4 * q + 1] = v.y;
      y[4 * q + 2] = v.z;
      y[4 * q + 3] = v.w;
    }
  }
}

template <int DMAX>
__device__ __forceinline__ void store_row(const float (&y)[DMAX], float* row,
                                          int d) {
#pragma unroll
  for (int q = 0; q < DMAX / 4; ++q)
    if (4 * q < d)
      reinterpret_cast<float4*>(row)[q] =
          make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
}

// sum_i (y_i - row_i)^2 over i < d, in index order: the squared jump from
// the state in the row to the state y
template <int DMAX>
__device__ __forceinline__ float sq_jump(const float (&y)[DMAX],
                                         const float* row, int d) {
  float jump = 0.0f;
  float4 v;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i < d) {
      if ((i & 3) == 0) v = row_quad(row, i >> 2);
      const float dd = y[i] - quad_word(v, i & 3);
      jump += dd * dd;
    }
  }
  return jump;
}

// Propose y from the state in the thread's slab row xs (sn: its
// Box-Muller sine row; stage: its stage row) and test it.  Returns the decision; lp becomes the
// proposal's log-density on an accept.  The slab is left as it was.
template <int KIND, int PROP, int DRAW, int DMAX>
__device__ __forceinline__ bool mh_propose(
    float (&y)[DMAX], const float* xs, float* sn, float* stage, float& lp,
    int d,
    const float* __restrict__ params, float scale,
    const float* __restrict__ lap, float inv_d, float beta, int replica,
    int rung, int abs_step, uint32_t key0, uint32_t key1, uint4& blk,
    int& cur_k) {
  float4 xq;
  if constexpr (PROP != PROPOSAL_LAPLACE && DRAW == DRAW_BM) {
    bm_normals<DMAX>(y, sn, d, replica, rung, abs_step, key0, key1, blk,
                     cur_k);
    if constexpr (PROP == PROPOSAL_NORMAL) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        if (i < d) {
          if ((i & 3) == 0) xq = row_quad(xs, i >> 2);
          y[i] = quad_word(xq, i & 3) + __fmul_rn(y[i], scale);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        if ((i & 3) == 0) {
          blk = philox_block(i >> 2, replica, rung, abs_step, key0, key1);
          cur_k = i >> 2;
          if constexpr (PROP != PROPOSAL_UNIFORM_RADIUS)
            xq = row_quad(xs, i >> 2);
        }
        const float u = uniform_from_bits(philox_word(blk, i & 3));
        if constexpr (PROP == PROPOSAL_NORMAL) {
          y[i] = quad_word(xq, i & 3) +
                 __fmul_rn(icdf_layout_normal<DRAW>(u), scale);
        } else if constexpr (PROP == PROPOSAL_LAPLACE) {
          y[i] = quad_word(xq, i & 3) + laplace_increment(u, lap[i]);
        } else {
          y[i] = icdf_layout_normal<DRAW>(u);
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
      if (i < d) nrm2 += y[i] * y[i];
    const float den = fmaxf(sqrtf(nrm2), 1e-12f);
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        if ((i & 3) == 0) xq = row_quad(xs, i >> 2);
        y[i] = quad_word(xq, i & 3) + __fmul_rn(y[i] / den, r);
      }
    }
  }
  const float lp_prop = state_log_density<KIND, DMAX>(y, stage, d, params);
  const float log_ratio = beta * (lp_prop - lp);
  if constexpr (PROP != PROPOSAL_UNIFORM_RADIUS)
    w_mh = slot_word(d, blk, cur_k, replica, rung, abs_step, key0, key1);
  const float u = uniform_from_bits(w_mh);
  const bool accept = (log_ratio > 0.0f) || (u < expf(log_ratio));
  if (accept) lp = lp_prop;
  return accept;
}
