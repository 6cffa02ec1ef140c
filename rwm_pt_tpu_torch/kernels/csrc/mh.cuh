// One Metropolis-Hastings move of one (replica, rung) state held in
// registers, shared by fused_pt.cu and fused_rwm.cu: the MH body of
// rwm_pt_tpu/kernels/pallas_pt.py::_pt_body_fn (:57-68) and
// pallas_rwm.py::_make_kernel (:293-312).
//   eps_i = N_i * sigma (slots 0..d-1), y = x + eps, r = beta (lp(y) - lp(x)),
//   accept if r > 0 or u < exp(r) (slot d; NaN rejects).
// On return x holds the new state, p the state before the move, lp the new
// log-density and `jump` = sum_i (x_new_i - x_old_i)^2 (0 on reject).
// The product N*sigma is rounded on its own (__fmul_rn), as the plain version
// rounds it, instead of being contracted into the add.
#pragma once
#include "draws.cuh"
#include "philox.cuh"
#include "targets.cuh"

template <int KIND, int DMAX>
__device__ __forceinline__ bool mh_move(float (&x)[DMAX], float (&p)[DMAX],
                                        float& lp, float& jump, int d,
                                        const float* __restrict__ params,
                                        float sigma, float beta, int replica,
                                        int rung, int abs_step, uint32_t key0,
                                        uint32_t key1, uint4& blk,
                                        int& cur_k) {
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    if (i < d) {
      if ((i & 3) == 0) {
        blk = philox_block(i >> 2, replica, rung, abs_step, key0, key1);
        cur_k = i >> 2;
      }
      const float n = normal_icdf(uniform_from_bits(philox_word(blk, i & 3)));
      p[i] = x[i] + __fmul_rn(n, sigma);
    }
  }
  const float lp_prop = log_density<KIND, DMAX>(p, d, params);
  const float log_ratio = beta * (lp_prop - lp);
  const float u = uniform_from_bits(
      slot_word(d, blk, cur_k, replica, rung, abs_step, key0, key1));
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
