// The iterative ladder construction (rwm_pt_tpu/ladders/ladders.py::
// _device_ladder, the JAX package's one-program builder) as one persistent
// cooperative launch: the whole stochastic-approximation search, its
// Monte-Carlo swap estimates and its decisions, with no host round trip.
// Each library is built for one target kind (-DRWM_PT_TARGET, the 11
// kinds with a direct sampler) and one bucket (-DRWM_PT_DMAX: 8, 16, 32,
// 64, a sample's coordinates in registers; 128 or 256, in local memory).
//
// A probe of (beta, beta*) estimates a_hat = mean over n < N of
// min(1, exp((beta - beta*)(lp(x*_n) - lp(x_n)))), x*_n drawn from the
// target tempered at beta* and x_n at beta, each term in float32 as the
// plain version (ladders/ladders.py::_estimate_swap_prob) computes it.
// The grid (the occupancy API's blocks an SM times the SMs) takes the
// probe's tiles of kThreads samples grid-stride: thread t of a tile draws
// sample tile * kThreads + t on both sides from the ladder's Philox
// counters (kernels/draws.py: ladder_words, ladder_gamma), evaluates the
// two log-densities (csrc/targets.cuh::log_density) and its term; the
// block sums the tile's terms in double by a shared-memory tree; after a
// grid sync block 0 adds tile r kThreads + t into slot t in order of r and
// sums its slots by the same tree (ladders.py::partition_sum), and thread 0
// runs the search's state machine in double (ladders.py::
// _construct_iterative_ladder_device_plain) up to the next probe, whose
// betas it publishes before a second grid sync.  A sample's draws use the
// plain version's arithmetic, each product, quotient and sum rounded on
// its own (__fmul_rn, __fdiv_rn, __fadd_rn: nvcc would contract them), so
// the kernel and the plain version differ by the ulps of erfinvf, expf,
// logf and the matmul's order, never by the sum's.  Gamma variates
// (IIDGamma, IIDBeta) take bit-exact draws (normal_icdf_fastlog_rn,
// fast_log) in their rejection test, so both sides take the same attempts.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "draws.cuh"
#include "philox.cuh"
#include "targets.cuh"

namespace cg = cooperative_groups;

#ifndef RWM_PT_TARGET
#define RWM_PT_TARGET TARGET_MVN_ISO
#endif
#ifndef RWM_PT_DMAX
#define RWM_PT_DMAX 16
#endif

namespace {

constexpr int KIND = RWM_PT_TARGET;
constexpr int DMAX = RWM_PT_DMAX;
// a sample's loops unrolled whole in the register buckets; above them the
// arrays are in local memory anyway, and whole unrolling of 128 or 256
// coordinates (a Philox block and an erfinvf each) only costs build time
constexpr int kUnroll = DMAX <= 64 ? DMAX : 1;
// the full MVN's d x d products unrolled whole up to the 16 bucket (its
// x and z in registers); above it d^2 Philox-fed FMAs a sample make the
// whole unrolling take minutes to compile, and its arrays stay in local
// memory
constexpr int kFullUnroll = DMAX <= 16 ? DMAX : 1;
constexpr int kThreads = 256;   // a block, and a tile's samples
// blocks of the launch bound: 128 registers a thread at most (the full
// MVN, its d x d products unrolled, 255).  Without a bound ptxas picks 64
// for most kinds and spills a few words there, which way it goes turning
// on small edits to the search's code; at 128 the full MVN spills
constexpr int kMinBlocks = KIND == TARGET_MVN_FULL ? 1 : 2;
constexpr uint32_t kLadderTag = 0x80000000u;
constexpr uint32_t kGammaTag = 0x40000000u;
static_assert(KIND != TARGET_ROSENBROCK && KIND != TARGET_SUPER_FUNNEL,
              "FullRosenbrock and SuperFunnel have no direct sampler");

// ------------------------------------------------------------- the draws
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Giles' polynomial with each product and sum rounded on its own
// (kernels/draws.py::_giles_poly)
__device__ __forceinline__ float giles_poly_rn(float w) {
  const float wc = __fsub_rn(w, 2.5f);
  const float wt = __fsub_rn(sqrtf(w), 3.0f);
  const float c1[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                       -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                       -0.00417768164f,  0.246640727f,    1.50140941f};
  const float c2[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                       -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                       0.00943887047f,   1.00167406f,     2.83297682f};
  float pc = c1[0], pt = c2[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    pc = __fadd_rn(__fmul_rn(pc, wc), c1[i]);
    pt = __fadd_rn(__fmul_rn(pt, wt), c2[i]);
  }
  return w < 5.0f ? pc : pt;
}

// kernels/draws.py::normal_icdf_fastlog bit for bit: (sqrt(2) x) p(w),
// x = 2u - 1 + 2^-24, w = -fast_log(max((1 - x)(1 + x), 1e-37))
__device__ __forceinline__ float normal_icdf_fastlog_rn(float u) {
  const float x = __fadd_rn(__fsub_rn(__fmul_rn(2.0f, u), 1.0f),
                            1.0f / 16777216.0f);
  const float t = __fmul_rn(__fsub_rn(1.0f, x), __fadd_rn(1.0f, x));
  const float w = -fast_log(fmaxf(t, 1e-37f));
  return __fmul_rn(__fmul_rn(1.41421356237309515f, x), giles_poly_rn(w));
}

// The words of one side of one probe for sample n: slot j is word j & 3 of
// block j >> 2, Philox of (j >> 2, n, kLadderTag | side << 20, probe)
struct Slots {
  uint4 blk;
  int cur;
  uint32_t n, c2, probe, key0, key1;
  __device__ __forceinline__ Slots(int n_, int side, int probe_,
                                   uint32_t k0, uint32_t k1)
      : cur(-1), n((uint32_t)n_), c2(kLadderTag | (uint32_t)side << 20),
        probe((uint32_t)probe_), key0(k0), key1(k1) {}
  __device__ __forceinline__ float uniform(int j) {
    const int k = j >> 2;
    if (k != cur) {
      blk = philox4x32_10(make_uint4((uint32_t)k, n, c2, probe), key0, key1);
      cur = k;
    }
    return uniform_from_bits(philox_word(blk, j & 3));
  }
  __device__ __forceinline__ float normal(int j) {
    return normal_erfinv(uniform(j));
  }
};

// Gamma(alpha, 1) of coordinate j, gamma g of the sample (kernels/draws.py::
// ladder_gamma): Marsaglia-Tsang, attempt a from Philox of (a, n,
// kLadderTag | kGammaTag | side << 20 | g << 16 | j, probe); the boost's
// uniform is word 2 of attempt 0
__device__ float gamma_draw(float alpha, int n, int j, int g, int side,
                            int probe, uint32_t k0, uint32_t k1) {
  if (isnan(alpha)) return alpha;
  const bool boost = alpha < 1.0f;
  const float a = boost ? __fadd_rn(alpha, 1.0f) : alpha;
  const float dd = __fsub_rn(a, __int_as_float(0x3eaaaaab));   // f32(1/3)
  const float c = __fdiv_rn(1.0f, sqrtf(__fmul_rn(9.0f, dd)));
  const uint32_t c2 = kLadderTag | kGammaTag | (uint32_t)side << 20 |
                      (uint32_t)g << 16 | (uint32_t)j;
  float u0 = 0.0f, out = 0.0f;
  for (uint32_t att = 0;; ++att) {
    const uint4 w = philox4x32_10(
        make_uint4(att, (uint32_t)n, c2, (uint32_t)probe), k0, k1);
    if (att == 0) u0 = uniform_from_bits(w.z);
    const float x = normal_icdf_fastlog_rn(uniform_from_bits(w.x));
    const float t = __fadd_rn(1.0f, __fmul_rn(c, x));
    if (!(t > 0.0f)) continue;
    const float v = __fmul_rn(__fmul_rn(t, t), t);
    float rhs = __fadd_rn(__fmul_rn(0.5f, __fmul_rn(x, x)), dd);
    rhs = __fsub_rn(rhs, __fmul_rn(dd, v));
    rhs = __fadd_rn(rhs, __fmul_rn(dd, fast_log(v)));
    if (fast_log(uniform_from_bits(w.y)) < rhs) {
      out = __fmul_rn(dd, v);
      break;
    }
  }
  if (boost) out = __fmul_rn(out, expf(__fdiv_rn(fast_log(u0), alpha)));
  return out;
}

// One sample of the target tempered at beta (float32), into x[0 .. d-1]:
// the target's stream_sample (targets/*.py) in its arithmetic.  sp: the
// sampler's parameters (kernels/ladder_build.py::sampler_params).
__device__ __forceinline__ void draw_sample(float (&x)[DMAX], int d, int n,
                                            int side, int probe, float beta,
                                            const float* __restrict__ sp,
                                            bool bf16, uint32_t k0,
                                            uint32_t k1) {
  Slots s(n, side, probe, k0, k1);
  const float sb = sqrtf(beta);
  if constexpr (KIND == TARGET_MVN_ISO) {
    // mean + z (I / sqrt(beta))^T: coordinate i's one product
    const float inv = bf16 ? bf16_round(__fdiv_rn(1.0f, sb))
                           : __fdiv_rn(1.0f, sb);
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float z = bf16 ? bf16_round(s.normal(i)) : s.normal(i);
        x[i] = __fadd_rn(sp[i], __fmul_rn(z, inv));
      }
    }
  } else if constexpr (KIND == TARGET_MVN_FULL) {
    // mean + z (L / sqrt(beta))^T, each row's product accumulated in
    // order of j: by columns, so that z_j is used as it is drawn
    const float* L = sp + d;
    const int m = DMAX <= 16 ? DMAX : d;   // as in mvn_full_lp
#pragma unroll (kFullUnroll)
    for (int i = 0; i < m; ++i)
      if (i < d) x[i] = 0.0f;
#pragma unroll (kFullUnroll)
    for (int j = 0; j < m; ++j) {
      if (j < d) {
        const float zj = bf16 ? bf16_round(s.normal(j)) : s.normal(j);
#pragma unroll (kFullUnroll)
        for (int i = 0; i < m; ++i) {
          if (i < d) {
            const float sc = __fdiv_rn(L[i * d + j], sb);
            x[i] = fmaf(zj, bf16 ? bf16_round(sc) : sc, x[i]);
          }
        }
      }
    }
#pragma unroll (kFullUnroll)
    for (int i = 0; i < m; ++i)
      if (i < d) x[i] = __fadd_rn(sp[i], x[i]);
  } else if constexpr (KIND == TARGET_SCALED_MVN) {
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i)
      if (i < d)
        x[i] = __fmul_rn(s.normal(i),
                         __fdiv_rn(1.0f, __fmul_rn(sp[i], sb)));
  } else if constexpr (KIND == TARGET_THREE_MIXTURE) {
    // [cw0, cw1, s (d), means (3 x d)]: mode k of slot d's uniform
    const float u = s.uniform(d);
    const int k = (u >= sp[0]) + (u >= sp[1]);
    const float* mu = sp + 2 + d + k * d;
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i)
      if (i < d)
        x[i] = __fdiv_rn(__fadd_rn(mu[i], __fdiv_rn(s.normal(i), sb)),
                         sp[2 + i]);
  } else if constexpr (KIND == TARGET_ROUGH_CARPET) {
    // [cw0, cw1, modes (3), s (d)]: coordinate i's mode from slot d + i
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i)
      if (i < d) x[i] = __fdiv_rn(s.normal(i), sb);
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float u = s.uniform(d + i);
        const int k = (u >= sp[0]) + (u >= sp[1]);
        x[i] = __fdiv_rn(__fadd_rn(sp[2 + k], x[i]), sp[5 + i]);
      }
    }
  } else if constexpr (KIND == TARGET_EVEN_ROSENBROCK) {
    // [a, b, mu of the pairs (d / 2)]
    const float sa = sqrtf(__fdiv_rn(1.0f, __fmul_rn(2.0f,
                                                     __fmul_rn(sp[0], beta))));
    const float sq = sqrtf(__fdiv_rn(1.0f, __fmul_rn(2.0f,
                                                     __fmul_rn(sp[1], beta))));
#pragma unroll (kUnroll)
    for (int i = 0; i + 1 < DMAX; i += 2) {
      if (i < d) {
        const float f = __fadd_rn(sp[2 + i / 2], __fmul_rn(s.normal(i), sa));
        x[i] = f;
        x[i + 1] = __fadd_rn(__fmul_rn(f, f), __fmul_rn(s.normal(i + 1), sq));
      }
    }
  } else if constexpr (KIND == TARGET_HYBRID_ROSENBROCK) {
    // [a, b, mu, n1]: a block's first variable hangs off x_0
    const float sg = sqrtf(__fdiv_rn(1.0f, __fmul_rn(2.0f,
                                                     __fmul_rn(sp[0], beta))));
    const float sk = sqrtf(__fdiv_rn(1.0f, __fmul_rn(2.0f,
                                                     __fmul_rn(sp[1], beta))));
    const int blk = (int)sp[3] - 1;
    x[0] = __fadd_rn(sp[2], __fmul_rn(s.normal(0), sg));
#pragma unroll (kUnroll)
    for (int k = 1; k < DMAX; ++k) {
      if (k < d) {
        const float par = (k - 1) % blk == 0 ? x[0] : x[k - 1];
        x[k] = __fadd_rn(__fmul_rn(par, par), __fmul_rn(s.normal(k), sk));
      }
    }
  } else if constexpr (KIND == TARGET_HYPERCUBE) {
    const float w = __fsub_rn(sp[1], sp[0]);
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i)
      if (i < d) x[i] = __fadd_rn(__fmul_rn(s.uniform(i), w), sp[0]);
  } else if constexpr (KIND == TARGET_IID_GAMMA) {
    const float alpha = __fmul_rn(sp[0], beta);
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i)
      if (i < d)
        x[i] = __fmul_rn(gamma_draw(alpha, n, i, 0, side, probe, k0, k1),
                         sp[1]);
  } else if constexpr (KIND == TARGET_IID_BETA) {
    const float a1 = __fmul_rn(sp[0], beta), a2 = __fmul_rn(sp[1], beta);
#pragma unroll (kUnroll)
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        const float g1 = gamma_draw(a1, n, i, 0, side, probe, k0, k1);
        const float g2 = gamma_draw(a2, n, i, 1, side, probe, k0, k1);
        x[i] = __fdiv_rn(g1, __fadd_rn(g1, g2));
      }
    }
  } else {   // TARGET_NEAL_FUNNEL: [mu_v, sigma_v^2, mu_z]
    float t = __fmul_rn(__fsub_rn(1.0f, beta), (float)(d - 1));
    t = __fmul_rn(t, sp[1]);
    const float mean_v = __fadd_rn(sp[0], __fdiv_rn(t, __fmul_rn(2.0f, beta)));
    const float v = __fadd_rn(mean_v, __fmul_rn(sqrtf(__fdiv_rn(sp[1], beta)),
                                                s.normal(0)));
    x[0] = v;
    const float sc = __fdiv_rn(expf(__fdiv_rn(v, 2.0f)), sb);
#pragma unroll (kUnroll)
    for (int k = 1; k < DMAX; ++k)
      if (k < d) x[k] = __fadd_rn(sp[2], __fmul_rn(sc, s.normal(k)));
  }
}

// The full-covariance MVN's log-density, targets.cuh's order, with the
// product cov_inv (x - mean) at bfloat16 operands when bf16 (JAX's
// tensordot under jax.default_matmul_precision("bfloat16")); its loops
// unrolled whole up to the 16 bucket (kFullUnroll)
__device__ __forceinline__ float mvn_full_lp(const float (&x)[DMAX], int d,
                                             const float* __restrict__ p,
                                             bool bf16) {
  const float* cinv = p + 1 + d;
  const int m = DMAX <= 16 ? DMAX : d;   // a constant where unrolled
  float quad = 0.0f;
#pragma unroll (kFullUnroll)
  for (int i = 0; i < m; ++i) {
    if (i < d) {
      float y = 0.0f;
#pragma unroll (kFullUnroll)
      for (int j = 0; j < m; ++j) {
        if (j < d) {
          const float xc = x[j] - p[1 + j];
          y = bf16 ? fmaf(bf16_round(cinv[i * d + j]), bf16_round(xc), y)
                   : fmaf(cinv[i * d + j], xc, y);
        }
      }
      quad = fmaf(x[i] - p[1 + i], y, quad);
    }
  }
  return -0.5f * quad + p[0];
}

__device__ __forceinline__ float target_lp(const float (&x)[DMAX], int d,
                                           const float* __restrict__ p,
                                           bool bf16) {
  if constexpr (KIND == TARGET_MVN_FULL) {
    return mvn_full_lp(x, d, p, bf16);
  } else {
    return log_density<KIND, DMAX>(x, d, p);
  }
}

// min(1, exp((beta - beta*)(lp(x*) - lp(x)))) of sample n, in float32; a
// NaN stays NaN (torch.clamp_max's rule, not fminf's)
__device__ __forceinline__ float sample_term(
    int n, int probe, float bc, float bs, int d,
    const float* __restrict__ p, const float* __restrict__ sp, bool bf16,
    uint32_t k0, uint32_t k1) {
  float x[DMAX];
  draw_sample(x, d, n, 0, probe, bs, sp, bf16, k0, k1);
  const float lps = target_lp(x, d, p, bf16);
  draw_sample(x, d, n, 1, probe, bc, sp, bf16, k0, k1);
  const float lpc = target_lp(x, d, p, bf16);
  const float log_r = __fmul_rn(__fsub_rn(bc, bs), __fsub_rn(lps, lpc));
  return expf(isnan(log_r) ? log_r : fminf(log_r, 0.0f));
}

// ------------------------------------------------------------ the search
// The caller's settings: a kernel parameter, read from the constant bank
// (no registers held for them across the search's double arithmetic)
struct Settings {
  double rate, beta_min, tol, initial_pn, pn_lo, pn_hi, fail_tol;
  int max_pn, max_T, trace_cap;
  const double* pn_step;   // (max_pn,) nu^pn_power for nu = 1 .. max_pn
  double* betas;   // (max_T,)
  double* trace;   // (trace_cap,)
};

// The search's state (thread 0 of block 0, in shared memory)
struct Search {
  double beta_curr, pn, bstar, ahat;
  int t, probe, nu, it;
  bool in_rung, found, stop, failed;
};

// np.clip(v, lo, hi): min(max(v, lo), hi), NaN staying NaN
__device__ __forceinline__ double clip(double v, double lo, double hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// Run the search up to its next probe: true with (beta, beta*) of probe
// s.probe, or false when the ladder is done (finalised in c.betas, s.t).
__device__ bool search_next(Search& s, const Settings& c, double& bc,
                            double& bs) {
  for (;;) {
    if (!s.in_rung) {
      if (s.failed ||
          !(s.beta_curr > c.beta_min + 1e-6 && s.t < c.max_T - 1)) {
        if (c.betas[s.t - 1] > c.beta_min + 1e-5) c.betas[s.t++] = c.beta_min;
        return false;
      }
      s.pn = c.initial_pn;
      s.nu = 1;
      s.it = 0;
      s.found = s.stop = false;
      s.bstar = s.ahat = -1.0;
      s.in_rung = true;
    }
    if (!s.found && !s.stop && s.it < c.max_pn) {
      const double beta_star =
          s.beta_curr / (1.0 + exp(clip(s.pn, c.pn_lo, c.pn_hi)));
      s.bstar = beta_star;
      if (beta_star < c.beta_min) {
        s.stop = true;
        s.ahat = -1.0;
        continue;
      }
      ++s.probe;
      bc = s.beta_curr;
      bs = beta_star;
      return true;
    }
    const bool rescue = !s.found && !s.stop && s.it >= c.max_pn &&
                        s.bstar >= c.beta_min &&
                        fabs(s.ahat - c.rate) <= c.tol * c.fail_tol;
    s.in_rung = false;
    if (s.found || rescue) {
      c.betas[s.t++] = s.bstar;
      s.beta_curr = s.bstar;
    } else {
      s.failed = true;
    }
  }
}

// the estimate a of the last probe
__device__ __forceinline__ void search_take(Search& s, const Settings& c,
                                            double a) {
  if (s.probe - 1 < c.trace_cap) c.trace[s.probe - 1] = a;
  s.ahat = a;
  s.found = fabs(a - c.rate) <= c.tol;
  if (!s.found) s.pn = s.pn + c.pn_step[s.nu - 1] * (a - c.rate);
  ++s.nu;
  ++s.it;
}

// What block 0's thread 0 publishes for a probe
struct Control {
  int done, probe;
  float bc, bs;
};

__device__ __forceinline__ void tree_sum(double* red) {
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
}

struct Args {
  const float* params;    // log-density parameters (_build.kernel_target)
  const float* sparams;   // sampler parameters
  int n_params, stage, d, N, bf16;
  uint32_t key0, key1;
  double* tile_sums;      // (ceil(N / kThreads),)
  Control* ctl;
  double* out;            // [T, probes, betas (max_T), trace (trace_cap)]
  Settings set;
  Search init;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ladder_build_kernel(const __grid_constant__ Args a) {
  extern __shared__ float s_params[];
  __shared__ double red[kThreads];
  cg::grid_group grid = cg::this_grid();
  const float* p = a.params;
  if (a.stage) {
    for (int i = threadIdx.x; i < a.n_params; i += kThreads)
      s_params[i] = a.params[i];
    __syncthreads();
    p = s_params;
  }
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const Settings& c = a.set;
  __shared__ Search s;   // the lead thread's alone
  if (lead) {
    s = a.init;
    c.betas[0] = 1.0;
    for (int t = 1; t < c.max_T; ++t) c.betas[t] = c.beta_min;
    double bc = 0.0, bs = 0.0;
    const bool more = search_next(s, c, bc, bs);
    a.ctl->done = !more;
    a.ctl->probe = s.probe;
    a.ctl->bc = (float)bc;
    a.ctl->bs = (float)bs;
  }
  const int n_tiles = (a.N + kThreads - 1) / kThreads;
  grid.sync();
  volatile Control* vc = a.ctl;
  for (;;) {
    if (vc->done) break;
    const int probe = vc->probe;
    const float bc = vc->bc, bs = vc->bs;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int n = tile * kThreads + threadIdx.x;
      red[threadIdx.x] =
          n < a.N ? (double)sample_term(n, probe, bc, bs, a.d, p, a.sparams,
                                        a.bf16, a.key0, a.key1)
                  : 0.0;
      __syncthreads();
      tree_sum(red);
      if (threadIdx.x == 0) a.tile_sums[tile] = red[0];
      __syncthreads();
    }
    grid.sync();
    if (blockIdx.x == 0) {
      double acc = 0.0;
      for (int r = threadIdx.x; r < n_tiles; r += kThreads)
        acc += __ldcg(a.tile_sums + r);
      red[threadIdx.x] = acc;
      __syncthreads();
      tree_sum(red);
      if (lead) {
        search_take(s, c, red[0] / (double)a.N);
        double nbc = 0.0, nbs = 0.0;
        const bool more = search_next(s, c, nbc, nbs);
        vc->probe = s.probe;
        vc->bc = (float)nbc;
        vc->bs = (float)nbs;
        vc->done = !more;
      }
    }
    grid.sync();
  }
  if (lead) {
    a.out[0] = s.t;
    a.out[1] = s.probe;
  }
}

int blocks_per_sm(int shared, int& per_sm, int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ladder_build_kernel, kThreads, shared);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  return (int)e;
}

}  // namespace

// One build: params / sparams the log-density's and the sampler's
// parameters (device floats), d coordinates, N samples a side of a probe,
// the search's settings (JAX's _device_ladder, with the host builder's pn
// clamp and its exponent as the table pn_step of nu^pn_power, nu = 1 ..
// max_pn, computed by the host as the plain version computes it), the
// Philox key, bf16 the matmul operands' rounding, and the workspaces:
// tile_sums (ceil(N / 256) doubles), ctl (16 bytes), out (2 + max_T +
// trace_cap doubles: T, the probes, the ladder with beta_min in its
// unused slots, the first trace_cap probes' estimates).  A block of 256
// threads, the grid the
// blocks an SM holds times the SMs; one cooperative launch.
extern "C" int rwm_pt_ladder_build(
    const float* params, int n_params, const float* sparams, int d, int N,
    uint32_t key0, uint32_t key1, double rate, double beta_min, double tol,
    double initial_pn, const double* pn_step, double pn_lo, double pn_hi,
    int max_pn, double fail_tol, int max_T, int bf16,
    int trace_cap, double* tile_sums, void* ctl, double* out, void* stream) {
  if (d < 1 || d > DMAX || N < 1 || max_T < 2 || trace_cap < 0)
    return (int)cudaErrorInvalidValue;
  const int stage_bytes = 4 * n_params;
  const int stage = stage_bytes <= 32 * 1024;
  const int shared = stage ? stage_bytes : 0;
  int per_sm = 0, sms = 0;
  int e = blocks_per_sm(shared, per_sm, sms);
  if (e) return e;
  Args a;
  a.params = params;
  a.sparams = sparams;
  a.n_params = n_params;
  a.stage = stage;
  a.d = d;
  a.N = N;
  a.bf16 = bf16;
  a.key0 = key0;
  a.key1 = key1;
  a.tile_sums = tile_sums;
  a.ctl = (Control*)ctl;
  a.out = out;
  Settings& c = a.set;
  c.rate = rate;
  c.beta_min = beta_min;
  c.tol = tol;
  c.initial_pn = initial_pn;
  c.pn_step = pn_step;
  c.pn_lo = pn_lo;
  c.pn_hi = pn_hi;
  c.fail_tol = fail_tol;
  c.max_pn = max_pn;
  c.max_T = max_T;
  c.trace_cap = trace_cap;
  c.betas = out + 2;
  c.trace = out + 2 + max_T;
  Search& s = a.init;
  s.beta_curr = 1.0;
  s.pn = s.bstar = s.ahat = 0.0;
  s.t = 1;
  s.probe = s.nu = s.it = 0;
  s.in_rung = s.found = s.stop = s.failed = false;
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (void*)ladder_build_kernel, dim3(per_sm * sms), dim3(kThreads), args,
      shared, (cudaStream_t)stream);
}

// registers, local bytes, max threads a block, blocks an SM (at `shared`
// bytes of dynamic shared memory), SMs
extern "C" int rwm_pt_ladder_build_info(int shared, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ladder_build_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  const int r = blocks_per_sm(shared, per_sm, sms);
  if (r) return r;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = attr.maxThreadsPerBlock;
  out[3] = per_sm;
  out[4] = sms;
  return 0;
}
