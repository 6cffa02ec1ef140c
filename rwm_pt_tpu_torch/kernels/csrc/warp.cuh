// One warp a (replica, rung) state: the lane layout, the Metropolis-
// Hastings step and the log-densities of the fused kernels above 64
// dimensions (csrc/fused_pt_warp.cu, csrc/fused_rwm_warp.cu), the warp form
// of csrc/mh.cuh and csrc/targets.cuh.  kernels/_build.py mirrors the
// layout in Python (warp_slot_owner, warp_blocks, bm_lanes).
//
// Layout.  A warp bucket DMAX (128 or 256 slots, d + 4 <= DMAX) holds
// NQ = DMAX / 128 register quads a lane.  Coordinate i = 4q + w belongs
// to lane q mod 32, word w of its register quad floor(q / 32), and so does
// Philox slot i: lane l computes block q = 32 k + l of the counter
// (q, replica, rung, abs_step) for each k < NQ with 4q <= d + 3, so the
// blocks of a step run side by side and the stream is the one the plain
// versions consume (kernels/draws.py).  The MH uniform (slot d), the swap
// uniform (d + 1) and the radius uniform (d + 2) are broadcast from the
// lane that owns them with __shfl_sync; when d is not a multiple of 4
// they may sit in two lanes' blocks.
//
// Sums.  Every sum over the coordinates is a butterfly of
// __shfl_xor_sync: at each level lane l adds a_l + a_{l^m} and lane l^m
// adds a_{l^m} + a_l, the same float, so all 32 lanes end with the
// bit-identical lp, log-ratio and accept decision, and every lane stores
// its part of a move or none does (a sum read in another order by each
// lane would let lanes disagree and tear the row).  The two kinds whose
// terms differ in sign (IIDGamma, IIDBeta) stage their terms in the warp's
// shared row and every lane adds them in index order, the plain version's
// order (targets/base.py::sum0), which matters where lp is near 0; the
// others sum in the butterfly's order, within the agreement gate's
// tolerance of the plain version (kernels/agreement.py).
//
// Shared rows.  Each warp has a state row (DMAX words, float4 per lane:
// a warp's 16-byte accesses are contiguous, no bank conflicts) and a
// scratch row of DMAX words: the step's proposal words as the rolled loop
// over the register quads leaves them, and what crosses lanes: Box-Muller's angle
// uniforms and sines (pair k < h = ceil(d/2) is computed by the lane of
// coordinate k, its u2 read from slot h + k or d + 3, its sine written
// for the lane of coordinate k + h), the proposal for the neighbour terms
// of the Rosenbrock kinds, x - mean for the full-covariance quadratic
// form, and the IID kinds' terms.  __syncwarp orders each use.
#pragma once
#include "mh.cuh"

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void set_word(float4& v, int w, float f) {
  if (w == 0) v.x = f;
  else if (w == 1) v.y = f;
  else if (w == 2) v.z = f;
  else v.w = f;
}

// the coordinate (and slot) of word w of register quad k of lane `lane`
__device__ __forceinline__ int own_index(int k, int lane, int w) {
  return 4 * (32 * k + lane) + w;
}

// Butterfly sum: every lane ends with the same float.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFullMask, v, m);
  return v;
}

// Philox block q = 32 k + lane of the step (those that hold a slot of
// 0..d+3; zeros past them)
__device__ __forceinline__ uint4 lane_block(int q, int d, int replica,
                                            int rung, int abs_step,
                                            uint32_t key0, uint32_t key1) {
  return 4 * q <= d + 3
             ? philox_block(q, replica, rung, abs_step, key0, key1)
             : make_uint4(0u, 0u, 0u, 0u);
}

// The word of slot j (the same j in every lane) into w, from the lane that
// holds it, while the warp's register quad k holds block b: a shuffle in
// the one k whose quads hold slot j (a condition every lane takes alike)
__device__ __forceinline__ void take_slot(const uint4& b, int k, int j,
                                          uint32_t& w) {
  const int q = j >> 2;
  if (k == (q >> 5)) w = __shfl_sync(kFullMask, philox_word(b, j & 3), q & 31);
}

// The lane's quads of a row (zeros past d)
template <int NQ>
__device__ __forceinline__ void warp_load(float4 (&v)[NQ], const float* row,
                                          int d, int lane) {
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const int q = 32 * k + lane;
    v[k] = 4 * q < d ? row_quad(row, q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int NQ>
__device__ __forceinline__ void warp_store(const float4 (&v)[NQ], float* row,
                                           int d, int lane) {
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const int q = 32 * k + lane;
    if (4 * q < d) reinterpret_cast<float4*>(row)[q] = v[k];
  }
}

// Write the lane's quads to the warp's scratch row for the other lanes
template <int NQ>
__device__ __forceinline__ void warp_stage(const float4 (&v)[NQ], float* row,
                                           int d, int lane) {
  __syncwarp();
  warp_store<NQ>(v, row, d, lane);
  __syncwarp();
}

// sum_i (y_i - row_i)^2 over i < d, every lane the same float
template <int NQ>
__device__ __forceinline__ float warp_sq_jump(const float4 (&y)[NQ],
                                              const float* row, int d,
                                              int lane) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    const int q = 32 * k + lane;
    if (4 * q < d) {
      const float4 xq = row_quad(row, q);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (4 * q + w < d) {
          const float dd = quad_word(y[k], w) - quad_word(xq, w);
          s += dd * dd;
        }
      }
    }
  }
  return warp_sum(s);
}

// sum_{i < d} row[i] in index order, read by every lane alike
__device__ __forceinline__ float row_sum_in_order(const float* row, int d) {
  float s = 0.0f;
  for (int i = 0; i < d; ++i) s += row[i];
  return s;
}

// Box-Muller normals of the lane's coordinates (csrc/mh.cuh::bm_normals'
// map), from the uniforms of every slot, which the lanes have written to
// the scratch row: the angle uniforms and then the sines cross lanes there
template <int NQ>
__device__ __forceinline__ void warp_bm_normals(float4 (&n)[NQ], float* row,
                                                int d, int lane) {
  const int h = (d + 1) >> 1;
  __syncwarp();   // every slot's uniform is in the row
  float4 sn[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = own_index(k, lane, w);
      float rc = 0.0f, rs = 0.0f;
      if (i < h) {
        const float u1 = fmaxf(row[i], 1e-7f);
        const float u2 = row[h + i < d ? h + i : d + 3];
        float r;
        box_muller(u1, u2, r, rs, rc);
      }
      set_word(n[k], w, rc);
      set_word(sn[k], w, rs);
    }
  }
  __syncwarp();   // every angle uniform has been read
#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = own_index(k, lane, w);
      if (i < h && i + h < d) row[i + h] = quad_word(sn[k], w);
    }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = own_index(k, lane, w);
      if (i >= h && i < d) set_word(n[k], w, row[i]);
    }
}

// The log-density of the state y (the lane's quads; words past d are 0),
// csrc/targets.cuh's formulas; `row` is the warp's scratch row.
template <int KIND, int NQ>
__device__ __forceinline__ float warp_log_density(const float4 (&y)[NQ],
                                                  float* row, int d,
                                                  const float* p, int lane) {
  if constexpr (KIND == TARGET_ROSENBROCK || KIND == TARGET_EVEN_ROSENBROCK) {
    warp_stage<NQ>(y, row, d, lane);
    const int n = d - 1;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i < n) {
          const float xi = quad_word(y[k], w);
          const float xn = w < 3 ? quad_word(y[k], w + 1) : row[i + 1];
          if constexpr (KIND == TARGET_ROSENBROCK) {
            const float t = xn - xi * xi;
            s1 += p[1] * (t * t);
            const float u = xi - p[2 + i];
            s2 += p[0] * (u * u);
          } else {
            const float t1 = __fmul_rn(p[i], sq(xi - p[2 * n + i]));
            const float t2 = __fmul_rn(p[n + i], sq(xn - xi * xi));
            s1 += t1 + t2;
          }
        }
      }
    }
    if constexpr (KIND == TARGET_ROSENBROCK)
      return -(warp_sum(s1) + warp_sum(s2));
    else
      return -warp_sum(s1);
  } else if constexpr (KIND == TARGET_MVN_ISO || KIND == TARGET_SCALED_MVN) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i < d) {
          const float v = KIND == TARGET_MVN_ISO
                              ? quad_word(y[k], w) - p[1 + i]
                              : p[1 + i] * quad_word(y[k], w);
          s += v * v;
        }
      }
    s = warp_sum(s);
    if constexpr (KIND == TARGET_MVN_ISO)
      return -0.5f * s + p[0];
    else
      return p[0] - __fmul_rn(0.5f, s);
  } else if constexpr (KIND == TARGET_MVN_FULL) {
    // x - mean in the scratch row; lane l takes the columns j = l mod 32
    // of every row of the precision matrix, so a warp reads a row's
    // contiguous words (shared memory or L2, kernels/_build.py
    // params_in_shared)
    float4 xc[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        set_word(xc[k], w, i < d ? quad_word(y[k], w) - p[1 + i] : 0.0f);
      }
    warp_stage<NQ>(xc, row, d, lane);
    const float* cinv = p + 1 + d;
    float acc = 0.0f;
    for (int i = 0; i < d; ++i) {
      float t = 0.0f;
      for (int j = lane; j < d; j += 32) t = fmaf(cinv[i * d + j], row[j], t);
      acc = fmaf(row[i], t, acc);
    }
    return -0.5f * warp_sum(acc) + p[0];
  } else if constexpr (KIND == TARGET_THREE_MIXTURE) {
    const float* s = p + 5;
    const float* mu = p + 5 + d;
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i < d) {
          const float v = s[i] * quad_word(y[k], w);
          const float e0 = v - mu[i], e1 = v - mu[d + i],
                      e2 = v - mu[2 * d + i];
          q0 += e0 * e0;
          q1 += e1 * e1;
          q2 += e2 * e2;
        }
      }
    q0 = warp_sum(q0);
    q1 = warp_sum(q1);
    q2 = warp_sum(q2);
    const float c0 = (__fmul_rn(-0.5f, q0) - p[1]) + p[2];
    const float c1 = (__fmul_rn(-0.5f, q1) - p[1]) + p[3];
    const float c2 = (__fmul_rn(-0.5f, q2) - p[1]) + p[4];
    const float m = fmaxf(fmaxf(c0, c1), c2);
    const float m0 = isfinite(m) ? m : 0.0f;
    return (logf(expf(c0 - m0) + expf(c1 - m0) + expf(c2 - m0)) + m0) + p[0];
  } else if constexpr (KIND == TARGET_ROUGH_CARPET) {
    const float* s = p + 7;
    float total = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i < d) {
          const float v = s[i] * quad_word(y[k], w);
          const float a0 = p[1] - __fmul_rn(0.5f, sq(v - p[4]));
          const float a1 = p[2] - __fmul_rn(0.5f, sq(v - p[5]));
          const float a2 = p[3] - __fmul_rn(0.5f, sq(v - p[6]));
          const float m = fmaxf(fmaxf(a0, a1), a2);
          const float m0 = isfinite(m) ? m : 0.0f;
          total += (m + logf(expf(a0 - m0) + expf(a1 - m0) + expf(a2 - m0))) -
                   0.918938533204672742f;   // log sqrt(2 pi)
        }
      }
    return warp_sum(total) + p[0];
  } else if constexpr (KIND == TARGET_HYBRID_ROSENBROCK) {
    warp_stage<NQ>(y, row, d, lane);
    const float a = p[0], b = p[1];
    const float x0 = __shfl_sync(kFullMask, y[0].x, 0);
    const float x0sq = x0 * x0;
    float s_first = 0.0f, s_in = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i >= 1 && i < d) {
          const bool first = p[2 + i] != 0.0f;
          const float prev = w > 0 ? quad_word(y[k], w - 1) : row[i - 1];
          const float par = first ? x0sq : prev * prev;
          const float t = __fmul_rn(b, sq(quad_word(y[k], w) - par));
          if (first) s_first += t; else s_in += t;
        }
      }
    return (__fmul_rn(-a, sq(x0 - p[2])) - warp_sum(s_first)) -
           warp_sum(s_in);
  } else if constexpr (KIND == TARGET_HYPERCUBE) {
    bool inside = true;
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i < d)
          inside &= (quad_word(y[k], w) >= p[0]) & (quad_word(y[k], w) <= p[1]);
      }
    return __all_sync(kFullMask, inside) ? p[2] : -INFINITY;
  } else if constexpr (KIND == TARGET_IID_GAMMA || KIND == TARGET_IID_BETA) {
    bool valid = true;
    float4 t[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        float term = 0.0f;
        if (i < d) {
          const float xi = quad_word(y[k], w);
          if constexpr (KIND == TARGET_IID_GAMMA) {
            const bool pos = xi > 0.0f;
            valid &= pos;
            const float sx = pos ? xi : 1.0f;
            term = __fmul_rn(p[0] - 1.0f, logf(sx)) - sx / p[1];
          } else {
            const bool in = (xi > 0.0f) & (xi < 1.0f);
            valid &= in;
            const float sx = in ? xi : 0.5f;
            term = __fmul_rn(p[0] - 1.0f, logf(sx)) +
                   __fmul_rn(p[1] - 1.0f, log1pf(-sx));
          }
        }
        set_word(t[k], w, term);
      }
    warp_stage<NQ>(t, row, d, lane);
    const float s = row_sum_in_order(row, d);
    if (!__all_sync(kFullMask, valid)) return -INFINITY;
    return KIND == TARGET_IID_GAMMA ? s - p[2] : s + p[2];
  } else {   // TARGET_NEAL_FUNNEL
    const float v = __shfl_sync(kFullMask, y[0].x, 0);
    const float prior = p[3] - __fmul_rn(0.5f, sq(v - p[0])) / p[1];
    if (d == 1) return prior;
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i >= 1 && i < d) {
          const float z = quad_word(y[k], w) - p[2];
          ss += __fmul_rn(z, z);
        }
      }
    ss = warp_sum(ss);
    const float lik = (p[4] - __fmul_rn(p[5], v)) -
                      __fmul_rn(__fmul_rn(0.5f, expf(-v)), ss);
    return prior + lik;
  }
}

// Propose y from the state in the warp's state row xs and test it
// (csrc/mh.cuh::mh_propose in warp form).  Returns the decision, the same
// in every lane; lp becomes the proposal's log-density on an accept;
// u_swap is the uniform of slot d + 1 (PT's pair uniform).  The state row
// is left as it was.  A loop over the lane's register quads, kept rolled
// (one inlined copy of the normal draw, however many quads a lane has),
// computes each quad's Philox block and uses it up there: the broadcast
// slots it holds, and its proposal words (Normal, Laplace), normals
// (UniformRadius) or uniforms (Box-Muller) into the scratch row, from
// which the lane reads its own quads back.
template <int KIND, int PROP, int DRAW, int NQ>
__device__ __forceinline__ bool warp_mh_propose(
    float4 (&y)[NQ], const float* xs, float* row, float& lp, int d,
    const float* p, float scale, const float* lap, float inv_d, float beta,
    int lane, int replica, int rung, int abs_step, uint32_t key0,
    uint32_t key1, float& u_swap) {
  constexpr bool kBM = PROP != PROPOSAL_LAPLACE && DRAW == DRAW_BM;
  constexpr bool kUR = PROP == PROPOSAL_UNIFORM_RADIUS;
  uint32_t w_mh = 0u, w_sw = 0u, w_r = 0u;
  __syncwarp();   // the scratch row's last readers are done
#pragma unroll 1
  for (int k = 0; k < NQ; ++k) {
    const int q = 32 * k + lane;
    const uint4 b = lane_block(q, d, replica, rung, abs_step, key0, key1);
    take_slot(b, k, d, w_mh);
    take_slot(b, k, d + 1, w_sw);
    if constexpr (kUR) take_slot(b, k, d + 2, w_r);
    float4 v;
    if constexpr (kBM) {
      v = make_float4(uniform_from_bits(b.x), uniform_from_bits(b.y),
                      uniform_from_bits(b.z), uniform_from_bits(b.w));
    } else {
      const float4 xq =
          4 * q < d ? row_quad(xs, q) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 4 * q + w;
        const float u = uniform_from_bits(philox_word(b, w));
        float out = 0.0f;
        if (i < d) {
          if constexpr (PROP == PROPOSAL_LAPLACE)
            out = quad_word(xq, w) + laplace_increment(u, lap[i]);
          else if constexpr (kUR)
            out = icdf_layout_normal<DRAW>(u);
          else
            out = quad_word(xq, w) +
                  __fmul_rn(icdf_layout_normal<DRAW>(u), scale);
        }
        set_word(v, w, out);
      }
    }
    if (4 * q <= d + 3) reinterpret_cast<float4*>(row)[q] = v;
  }
  float4 n[NQ];   // the normals (Box-Muller, UniformRadius)
  if constexpr (kBM) {
    warp_bm_normals<NQ>(n, row, d, lane);
  } else {
#pragma unroll
    for (int k = 0; k < NQ; ++k) {   // the lane's own words of the row
      const int q = 32 * k + lane;
      const float4 v =
          4 * q < d ? row_quad(row, q) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kUR) n[k] = v; else y[k] = v;
    }
  }
  if constexpr (kBM && !kUR) {
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int q = 32 * k + lane;
      const float4 xq =
          4 * q < d ? row_quad(xs, q) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        set_word(y[k], w, 4 * q + w < d
                              ? quad_word(xq, w) +
                                    __fmul_rn(quad_word(n[k], w), scale)
                              : 0.0f);
    }
  }
  if constexpr (kUR) {   // the uniform ball: direction n / ||n||
    float nrm2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (own_index(k, lane, w) < d)
          nrm2 += quad_word(n[k], w) * quad_word(n[k], w);
    nrm2 = warp_sum(nrm2);
    const float r = scale * expf(logf(uniform_from_bits(w_r)) * inv_d);
    const float den = fmaxf(sqrtf(nrm2), 1e-12f);
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      const int q = 32 * k + lane;
      const float4 xq =
          4 * q < d ? row_quad(xs, q) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w)
        set_word(y[k], w, 4 * q + w < d
                              ? quad_word(xq, w) +
                                    __fmul_rn(quad_word(n[k], w) / den, r)
                              : 0.0f);
    }
  }
  u_swap = uniform_from_bits(w_sw);
  const float u = uniform_from_bits(w_mh);
  const float lp_prop = warp_log_density<KIND, NQ>(y, row, d, p, lane);
  const float log_ratio = beta * (lp_prop - lp);
  const bool accept = (log_ratio > 0.0f) || (u < expf(log_ratio));
  if (accept) lp = lp_prop;
  return accept;
}
