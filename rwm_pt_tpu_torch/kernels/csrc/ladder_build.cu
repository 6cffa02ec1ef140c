// The iterative ladder construction (rwm_pt_tpu/ladders/ladders.py::
// _device_ladder, the JAX package's one-program builder) as one persistent
// cooperative launch: the whole stochastic-approximation search, its
// Monte-Carlo swap estimates and its decisions, with no host round trip.
// Each library is built for one target kind (-DRWM_PT_TARGET, the 11
// kinds with a direct sampler) and one bucket (-DRWM_PT_DMAX: 8, 16, 32 or
// 64, whose loops are unrolled whole; 128 to 4096, rolled).
//
// A probe of (beta, beta*) estimates a_hat = mean over n < N of
// min(1, exp((beta - beta*)(lp(x*_n) - lp(x_n)))), x*_n drawn from the
// target tempered at beta* (side 0) and x_n at beta (side 1), each term in
// float32 as the plain version (ladders/ladders.py::_estimate_swap_prob)
// computes it, summed in float64 over a fixed partition
// (ladders.py::partition_sum): tiles of 256 samples, each summed by a
// halving tree (t += t + w, w = 128 .. 1); tile r 256 + t added in order of
// r into slot t; the 256 slots by the same tree.  The kernel and the plain
// version therefore differ only by their terms, never by the sum.
//
// What bounds it.  Per sample a side draws ceil(words / 4) Philox blocks
// (60 int32 operations each), a normal (erfinvf) and the sampler's
// quotients a coordinate, and sums its log-density: at N = 10^6 that work
// binds (chip_smoke.py::ladder_work); below a wave of tiles a probe is one
// sample's chain of dependent operations, then the probe's reduction,
// barrier and search.  The design, for both:
//
// * Two lanes a sample: lane j < 16 of a warp draws side 0 of a sample,
//   lane j + 16 side 1 of the same sample, each from its own Philox blocks
//   (counter (k, n, kLadderTag | side << 20, probe)); the lp crosses by one
//   __shfl_xor_sync and lane j computes the term.  The two chains run side
//   by side and a thread holds one side's state.
// * The log-density is summed as each coordinate is drawn (side_lp's add,
//   in index order with csrc/targets.cuh's arithmetic, so that the lp is
//   the array form's bit for bit): no array of the sample's coordinates,
//   except for the full MVN's quadratic form.  In the unrolled buckets the
//   coordinates every d of the bucket has (kMinD) run with no bound test,
//   their first Philox blocks (kUp) made up front and their first draws
//   (kPre) before the sum, so that their chains overlap.
// * Sample 16 j + u of a tile is lane j of warp-unit u, so the tree's
//   levels 128 .. 16 pair lanes of one warp (__shfl_down_sync by 8, 4, 2,
//   1) and levels 8 .. 1 pair the 16 units' partials (then one warp's
//   shuffles): the tree's pairs and adds.  In the unrolled buckets a block
//   of 512 threads takes whole tiles grid-stride, a tile's unit u in its
//   warp u, one __syncthreads a tile; in the rolled buckets, where a
//   sample is long, each warp takes units (16 samples of a tile)
//   grid-stride, so that a few tiles still spread over every SM, and a
//   tile's last unit to finish (a count a tile) sums its partials.
// * One barrier a probe.  The grid is the blocks an SM holds times the
//   SMs, at most the blocks the probe's tiles (units) fill.  A block done
//   with its work arrives (an acquire-release add to a counter of
//   arrivals).  Up to kEveryTiles tiles every block then waits for the
//   grid's arrivals (ld.acquire) and adds the slots itself; above, the
//   last block to arrive adds them and publishes the sum (st.release;
//   Control), for which the others wait.  A probe's tile sums sit in
//   half probe & 1 of a double buffer, so no block writes the next
//   probe's over the sums another block still reads.  Every block runs
//   the search's state machine in double (search_take, search_next) on
//   the same sum, so nothing but the sums crosses the barrier; block 0
//   writes the ladder.
// * No sample divides by a probe's constants: each block's search thread
//   makes them once a probe (side_consts: 1 / sqrt(beta), the
//   Rosenbrocks' scales, the scaled MVN's reciprocals), and the mixtures'
//   quotients by sqrt(beta) and s_i take div_by, a product and two FMAs
//   that round as the IEEE quotient does.
// * The full-covariance MVN above the 16 bucket (kFullWarp) gives a side's
//   sample to a warp, not a lane: its d x d work a sample would otherwise
//   sit in one thread with its sample in local memory.  Once a probe the
//   grid makes each side's S = L / sqrt(beta) into a global table,
//   column-major (the lower triangle: L is a Cholesky factor, and its zero
//   upper triangle adds exact zeros), and once a build cov_inv's
//   transpose; then each warp takes side-samples grid-stride: its lanes
//   draw z (Philox block k by lane k mod 32) into the warp's row in shared
//   memory, split the rows i of x = mean + S z (row i = 32 r + lane of a
//   chunk of 256, eight a lane, x_i summed over j in order, z_j read from
//   the row by every lane alike), in chunks from the last, so that x - mean
//   replaces the z's no later chunk reads; then the rows of y =
//   cov_inv (x - mean) likewise (y_i over j in order), and lane 0 sums
//   quad over i in index order.  Every product and sum is the one-lane
//   form's, in its order, so the lp is bit for bit the one-lane form's
//   (a lane a side-sample, its x in local memory); the lps go to a
//   global buffer, and after a grid barrier the warp-units read them in
//   place of drawing.  Two grid barriers a probe (table, lps) beside the
//   probe's own.

// A sample's draws use the plain version's arithmetic, each product,
// quotient and sum rounded on its own (__fmul_rn, __fdiv_rn, __fadd_rn:
// nvcc would contract them), so the kernel and the plain version differ by
// the ulps of erfinvf, expf, logf and the matmul's order.  Gamma variates
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
constexpr int kTile = 256;            // a tile's samples
// up to this many tiles a probe every block adds the slots itself (on an
// H100 0.46-0.56 us a probe less than a published sum at 12 tiles, 0.07-
// 0.85 us more at 79: PERF.md §6, PR 14's call 13)
constexpr int kEveryTiles = 16;
constexpr int kUnits = 16;            // warp-units a tile (16 samples each)
constexpr bool kRolled = DMAX > 64;   // the rolled buckets
// the bucket's least d (kernels/_build.py: bucket, warp_bucket): the
// register buckets' and the 128 bucket's DMAX / 2 + 1, the warp buckets'
// above it DMAX / 2 - 3 (their slots hold d + 4 words: 125, 253, 509)
constexpr int kMinD = DMAX <= 8     ? 1
                      : DMAX <= 128 ? DMAX / 2 + 1
                                    : DMAX / 2 - 3;
// a block: whole tiles (512 threads) in the unrolled buckets, warp-units
// in the rolled ones
constexpr int kThreads = kRolled ? 256 : 512;
constexpr int kWarps = kThreads / 32;
// the kinds whose quotients take div_by where the build allows it
constexpr bool kQuotients =
    KIND == TARGET_THREE_MIXTURE || KIND == TARGET_ROUGH_CARPET;
// blocks of the launch bound: 64 registers a thread (128: the full MVN in
// the unrolled buckets, its d x d products unrolled up to the 16 bucket,
// and the mixtures' 32 and 64 buckets, whose unrolled quotients spilled
// 8-72 B at 64)
constexpr int kMinBlocks =
    (KIND == TARGET_MVN_FULL || (kQuotients && DMAX > 16)) && !kRolled
        ? 1
        : 2048 / kThreads / 2;
// the full MVN's d x d products unrolled whole up to the 16 bucket (its
// x and z in registers); above it d^2 Philox-fed FMAs a sample make the
// whole unrolling take minutes to compile, and a warp takes a side-sample
// (kFullWarp)
constexpr int kFullUnroll = DMAX <= 16 ? DMAX : 1;
// the unrolled buckets' first coordinates drawn before the sum (kPre) and
// Philox blocks made up front (kUp), all of them below kMinD
constexpr int kPre = kRolled ? 0 : (kMinD < 12 ? kMinD : 12);
constexpr int kUp = kRolled ? 0 : ((kMinD + 3) / 4 < 4 ? (kMinD + 3) / 4 : 4);
// a side's per-probe row in shared memory, made by the block at each
// probe's start: the scaled MVN's reciprocals 1 / (s_i sqrt(beta)), the
// full MVN's L_ij / sqrt(beta) up to the 16 bucket
constexpr bool kFullTable = KIND == TARGET_MVN_FULL && DMAX <= 16;
// the full MVN above it: a warp a side-sample, S and cov_inv^T in global
// tables (the header)
constexpr bool kFullWarp = KIND == TARGET_MVN_FULL && !kFullTable;
constexpr int kChunk = 256;           // rows a pass of a warp: 8 a lane
constexpr uint32_t kLadderTag = 0x80000000u;
constexpr uint32_t kGammaTag = 0x40000000u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStampOffset = 256;   // ctl's bytes before a bench's stamps
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

__device__ __forceinline__ float normal_of(uint32_t word) {
  return normal_erfinv(uniform_from_bits(word));
}

// One side of one sample: block k of its words is Philox of (k, n,
// kLadderTag | side << 20, probe), slot j word j & 3 of block j >> 2
struct Side {
  uint32_t n, c2, probe, k0, k1;
  __device__ __forceinline__ uint4 block(int k) const {
    return philox4x32_10(make_uint4((uint32_t)k, n, c2, probe), k0, k1);
  }
};

// Gamma(alpha, 1) of coordinate j, gamma g of the sample (kernels/draws.py::
// ladder_gamma): Marsaglia-Tsang, attempt a from Philox of (a, n,
// kLadderTag | kGammaTag | side << 20 | g << 16 | j, probe); the boost's
// uniform is word 2 of attempt 0
__device__ float gamma_draw(float alpha, const Side& s, int j, int g) {
  if (isnan(alpha)) return alpha;
  const bool boost = alpha < 1.0f;
  const float a = boost ? __fadd_rn(alpha, 1.0f) : alpha;
  const float dd = __fsub_rn(a, __int_as_float(0x3eaaaaab));   // f32(1/3)
  const float c = __fdiv_rn(1.0f, sqrtf(__fmul_rn(9.0f, dd)));
  const uint32_t c2 = s.c2 | kGammaTag | (uint32_t)g << 16 | (uint32_t)j;
  float u0 = 0.0f, out = 0.0f;
  for (uint32_t att = 0;; ++att) {
    const uint4 w =
        philox4x32_10(make_uint4(att, s.n, c2, s.probe), s.k0, s.k1);
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

// A side's coordinates in index order: draw(i, word of slot i) gives
// coordinate i, add(i, x) sums its log-density term.  The unrolled buckets
// make kUp blocks up front (their Philox chains overlap), draw the first
// kPre coordinates before summing any, and test no coordinate or block
// below kMinD against d; the rolled buckets loop over blocks, each
// block's four coordinates drawn, then summed.  Block `pin` (made first
// by the caller, ThreeMixture's and RoughCarpet's slot d) is `pinned`,
// not made again; -1: none, or one of the up-front blocks.
struct Coords {
  const Side& s;
  uint4 up[kUp > 0 ? kUp : 1];

  __device__ __forceinline__ explicit Coords(const Side& s_) : s(s_) {
#pragma unroll
    for (int k = 0; k < kUp; ++k) up[k] = s.block(k);
  }

  // block k (a run-time k): selected among the up-front blocks, else made
  __device__ __forceinline__ uint4 block(int k) const {
    if (k >= kUp) return s.block(k);
    uint4 b = up[0];
#pragma unroll
    for (int j = 1; j < kUp; ++j) b = k == j ? up[j] : b;
    return b;
  }

  template <class Draw, class Add>
  __device__ __forceinline__ void run(int d, int pin, const uint4& pinned,
                                      Draw draw, Add add) const {
    if constexpr (!kRolled) {
      static_assert(kPre <= 4 * kUp, "the first draws read up-front blocks");
      float pre[kPre];
#pragma unroll
      for (int i = 0; i < kPre; ++i)
        pre[i] = draw(i, philox_word(up[i >> 2], i & 3));
      uint4 cur = up[0];
#pragma unroll
      for (int i = 0; i < kPre; ++i) add(i, pre[i]);
#pragma unroll
      for (int i = kPre; i < DMAX; ++i) {
        if (i < kMinD || i < d) {
          const int k = i >> 2;
          if (k >= kUp && (i & 3) == 0) cur = k == pin ? pinned : s.block(k);
          add(i, draw(i, philox_word(k < kUp ? up[k] : cur, i & 3)));
        }
      }
    } else {
#pragma unroll 1
      for (int k = 0; 4 * k < d; ++k) {
        const uint4 b = k == pin ? pinned : s.block(k);
        float x[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (4 * k + w < d) x[w] = draw(4 * k + w, philox_word(b, w));
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (4 * k + w < d) add(4 * k + w, x[w]);
      }
    }
  }
};

// The same order for the gamma kinds, whose coordinates take no slot
// words (draw(i) from their own counters)
template <class Draw, class Add>
__device__ __forceinline__ void coordinates_wordless(int d, Draw draw,
                                                     Add add) {
  if constexpr (!kRolled) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < kMinD || i < d) add(i, draw(i));
  } else {
#pragma unroll 1
    for (int i = 0; i < d; ++i) add(i, draw(i));
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

// A side's per-probe constants, functions of its beta made once a probe by
// each block's search thread (side_consts), so that no sample divides by
// them: sb = sqrt(beta) and, by kind, k0 and k1 (below); the scaled and
// the full MVN's go to a shared row (row_words)
struct SideConst {
  float beta, sb, k0, k1;
};

// a / b rounded to nearest from y = RN(1 / b): q = RN(a y), the residual
// a - b q (exact) and RN(q + (a - b q) y), which is RN(a / b) while no
// quotient or residual leaves the normal range (Markstein's theorem; the
// callers' `fast`)
__device__ __forceinline__ float div_by(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

__device__ __forceinline__ SideConst side_consts(float beta,
                                                 const float* __restrict__ sp,
                                                 int d, bool bf16) {
  SideConst k{beta, sqrtf(beta), 0.0f, 0.0f};
  if constexpr (KIND == TARGET_MVN_ISO) {
    // mean + z (I / sqrt(beta))^T: coordinate i's one product
    const float inv = __fdiv_rn(1.0f, k.sb);
    k.k0 = bf16 ? bf16_round(inv) : inv;
  } else if constexpr (KIND == TARGET_THREE_MIXTURE ||
                       KIND == TARGET_ROUGH_CARPET) {
    k.k0 = __fdiv_rn(1.0f, k.sb);
  } else if constexpr (KIND == TARGET_EVEN_ROSENBROCK ||
                       KIND == TARGET_HYBRID_ROSENBROCK) {
    k.k0 = sqrtf(__fdiv_rn(1.0f, __fmul_rn(2.0f, __fmul_rn(sp[0], beta))));
    k.k1 = sqrtf(__fdiv_rn(1.0f, __fmul_rn(2.0f, __fmul_rn(sp[1], beta))));
  } else if constexpr (KIND == TARGET_HYPERCUBE) {
    k.k0 = __fsub_rn(sp[1], sp[0]);
  } else if constexpr (KIND == TARGET_IID_GAMMA || KIND == TARGET_IID_BETA) {
    k.k0 = __fmul_rn(sp[0], beta);
    k.k1 = __fmul_rn(sp[1], beta);
  } else if constexpr (KIND == TARGET_NEAL_FUNNEL) {
    // [mu_v, sigma_v^2, mu_z]: the mean of v and its scale
    float t = __fmul_rn(__fsub_rn(1.0f, beta), (float)(d - 1));
    t = __fmul_rn(t, sp[1]);
    k.k0 = __fadd_rn(sp[0], __fdiv_rn(t, __fmul_rn(2.0f, beta)));
    k.k1 = sqrtf(__fdiv_rn(sp[1], beta));
  }
  return k;
}

// The log-density of one side's sample tempered at beta (float32): the
// target's stream_sample (targets/*.py) in its arithmetic, and
// targets.cuh::log_density of it, each coordinate's term summed as it is
// drawn (the draws' own running state, the `d*` variables, apart from the
// sum's: the unrolled buckets draw kPre coordinates before summing).
// p: the log-density's parameters (kernels/_build.py::kernel_target), sp:
// the sampler's (kernels/ladder_build.py::sampler_params), k the side's
// constants, rs its per-probe row (row_words), ys the reciprocals of the
// mixtures' divisors s_i and kFast whether their quotients take div_by.
template <bool kFast>
__device__ __forceinline__ float side_lp(const Side& s, int d,
                                         const SideConst& k,
                                         const float* __restrict__ p,
                                         const float* __restrict__ sp,
                                         const float* rs, const float* ys,
                                         bool bf16) {
  const float sb = k.sb;
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (KIND == TARGET_IID_GAMMA) {
    const float sh1 = p[0] - 1.0f;
    bool valid = true;
    float acc = 0.0f;
    coordinates_wordless(
        d, [&](int i) { return __fmul_rn(gamma_draw(k.k0, s, i, 0), sp[1]); },
        [&](int i, float x) {
          const bool pos = x > 0.0f;
          valid &= pos;
          const float sx = pos ? x : 1.0f;
          acc += __fmul_rn(sh1, logf(sx)) - sx / p[1];
        });
    return valid ? acc - p[2] : -INFINITY;
  } else if constexpr (KIND == TARGET_IID_BETA) {
    const float am = p[0] - 1.0f, bm = p[1] - 1.0f;
    bool valid = true;
    float acc = 0.0f;
    coordinates_wordless(
        d,
        [&](int i) {
          const float g1 = gamma_draw(k.k0, s, i, 0);
          const float g2 = gamma_draw(k.k1, s, i, 1);
          return __fdiv_rn(g1, __fadd_rn(g1, g2));
        },
        [&](int i, float x) {
          const bool in = (x > 0.0f) & (x < 1.0f);
          valid &= in;
          const float sx = in ? x : 0.5f;
          acc += __fmul_rn(am, logf(sx)) + __fmul_rn(bm, log1pf(-sx));
        });
    return valid ? acc + p[2] : -INFINITY;
  } else {
    const Coords cs(s);
    if constexpr (KIND == TARGET_MVN_ISO) {
      const float inv = k.k0;
      float quad = 0.0f;
      cs.run(
          d, -1, none,
          [&](int i, uint32_t w) {
            const float z = bf16 ? bf16_round(normal_of(w)) : normal_of(w);
            return __fadd_rn(sp[i], __fmul_rn(z, inv));
          },
          [&](int i, float x) {
            const float xc = x - p[1 + i];
            quad += xc * xc;
          });
      return -0.5f * quad + p[0];
    } else if constexpr (KIND == TARGET_MVN_FULL) {
      // (kFullTable: up to the 16 bucket, unrolled whole, x in registers)
      // mean + z (L / sqrt(beta))^T, each row's product accumulated in
      // order of j: by columns, so that z_j is used as it is drawn
      float x[DMAX];
      const int m = DMAX <= 16 ? DMAX : d;   // as in mvn_full_lp
#pragma unroll (kFullUnroll)
      for (int i = 0; i < m; ++i)
        if (i < d) x[i] = 0.0f;
      cs.run(
          d, -1, none,
          [&](int j, uint32_t w) {
            return bf16 ? bf16_round(normal_of(w)) : normal_of(w);
          },
          [&](int j, float zj) {
#pragma unroll (kFullUnroll)
            for (int i = 0; i < m; ++i) {
              if (i < d) {
                const float sc = rs[i * d + j];
                x[i] = fmaf(zj, bf16 ? bf16_round(sc) : sc, x[i]);
              }
            }
          });
#pragma unroll (kFullUnroll)
      for (int i = 0; i < m; ++i)
        if (i < d) x[i] = __fadd_rn(sp[i], x[i]);
      return mvn_full_lp(x, d, p, bf16);
    } else if constexpr (KIND == TARGET_SCALED_MVN) {
      float acc = 0.0f;
      cs.run(
          d, -1, none,
          [&](int i, uint32_t w) { return __fmul_rn(normal_of(w), rs[i]); },
          [&](int i, float x) {
            const float sx = p[1 + i] * x;
            acc += sx * sx;
          });
      return p[0] - __fmul_rn(0.5f, acc);
    } else if constexpr (KIND == TARGET_THREE_MIXTURE) {
      // [cw0, cw1, s (d), means (3 x d)]: mode k of slot d's uniform, its
      // block first
      const int pin = d >> 2;
      const uint4 bm = cs.block(pin);
      const float u = uniform_from_bits(philox_word(bm, d & 3));
      const int mk = (u >= sp[0]) + (u >= sp[1]);
      const float* mu = sp + 2 + d + mk * d;
      const float* sc = p + 5;
      const float* pm = p + 5 + d;
      const float ysb = k.k0;
      float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
      cs.run(
          d, pin >= kUp ? pin : -1, bm,
          [&](int i, uint32_t w) {
            if constexpr (kFast)
              return div_by(__fadd_rn(mu[i], div_by(normal_of(w), sb, ysb)),
                            sp[2 + i], ys[i]);
            return __fdiv_rn(__fadd_rn(mu[i], __fdiv_rn(normal_of(w), sb)),
                             sp[2 + i]);
          },
          [&](int i, float x) {
            const float y = sc[i] * x;
            const float e0 = y - pm[i], e1 = y - pm[d + i],
                        e2 = y - pm[2 * d + i];
            q0 += e0 * e0;
            q1 += e1 * e1;
            q2 += e2 * e2;
          });
      const float c0 = (__fmul_rn(-0.5f, q0) - p[1]) + p[2];
      const float c1 = (__fmul_rn(-0.5f, q1) - p[1]) + p[3];
      const float c2 = (__fmul_rn(-0.5f, q2) - p[1]) + p[4];
      const float m = fmaxf(fmaxf(c0, c1), c2);
      const float m0 = isfinite(m) ? m : 0.0f;
      return (logf(expf(c0 - m0) + expf(c1 - m0) + expf(c2 - m0)) + m0) +
             p[0];
    } else if constexpr (KIND == TARGET_ROUGH_CARPET) {
      // [cw0, cw1, modes (3), s (d)]: coordinate i's mode from slot d + i,
      // its block made as its first slot comes (block d >> 2 first, once)
      const int pin = d >> 2;
      const uint4 bm = cs.block(pin);
      uint4 mb = bm;
      int mcur = pin;
      const float* sc = p + 7;
      const float ysb = k.k0;
      float total = 0.0f;
      cs.run(
          d, pin >= kUp ? pin : -1, bm,
          [&](int i, uint32_t w) {
            const int j = d + i;
            if ((j >> 2) != mcur) {
              mcur = j >> 2;
              mb = s.block(mcur);
            }
            const float u = uniform_from_bits(philox_word(mb, j & 3));
            const int m = (u >= sp[0]) + (u >= sp[1]);
            if constexpr (kFast)
              return div_by(__fadd_rn(sp[2 + m], div_by(normal_of(w), sb, ysb)),
                            sp[5 + i], ys[i]);
            return __fdiv_rn(
                __fadd_rn(sp[2 + m], __fdiv_rn(normal_of(w), sb)), sp[5 + i]);
          },
          [&](int i, float x) {
            const float y = sc[i] * x;
            const float a0 = p[1] - __fmul_rn(0.5f, sq(y - p[4]));
            const float a1 = p[2] - __fmul_rn(0.5f, sq(y - p[5]));
            const float a2 = p[3] - __fmul_rn(0.5f, sq(y - p[6]));
            const float m = fmaxf(fmaxf(a0, a1), a2);
            const float m0 = isfinite(m) ? m : 0.0f;
            total +=
                (m + logf(expf(a0 - m0) + expf(a1 - m0) + expf(a2 - m0))) -
                0.918938533204672742f;   // log sqrt(2 pi)
          });
      return total + p[0];
    } else if constexpr (KIND == TARGET_EVEN_ROSENBROCK) {
      // [a, b, mu of the pairs (d / 2)]: x_2m = mu_m + z sa, x_2m+1 =
      // x_2m^2 + z sq (sa, sq: k0, k1); term i of the sum (i < d - 1) as
      // x_i+1 comes
      const float sa = k.k0, sqb = k.k1;
      const int n1 = d - 1;
      float df = 0.0f, prev = 0.0f, acc = 0.0f;
      cs.run(
          d, -1, none,
          [&](int i, uint32_t w) {
            if ((i & 1) == 0) {
              df = __fadd_rn(sp[2 + i / 2], __fmul_rn(normal_of(w), sa));
              return df;
            }
            return __fadd_rn(__fmul_rn(df, df), __fmul_rn(normal_of(w), sqb));
          },
          [&](int i, float x) {
            if (i > 0) {
              const int j = i - 1;
              const float t1 = __fmul_rn(p[j], sq(prev - p[2 * n1 + j]));
              const float t2 = __fmul_rn(p[n1 + j], sq(x - prev * prev));
              acc += t1 + t2;
            }
            prev = x;
          });
      return -acc;
    } else if constexpr (KIND == TARGET_HYBRID_ROSENBROCK) {
      // [a, b, mu, n1]: a block's first variable hangs off x_0 (sg, sk:
      // k0, k1)
      const float sg = k.k0, sk = k.k1;
      const int blk = (int)sp[3] - 1;
      const float a = p[0], b = p[1];
      float dx0 = 0.0f, dprev = 0.0f;
      float x0 = 0.0f, x0sq = 0.0f, prev = 0.0f, s_first = 0.0f, s_in = 0.0f;
      cs.run(
          d, -1, none,
          [&](int j, uint32_t w) {
            if (j == 0) {
              dx0 = dprev = __fadd_rn(sp[2], __fmul_rn(normal_of(w), sg));
              return dx0;
            }
            const float par = (j - 1) % blk == 0 ? dx0 : dprev;
            dprev =
                __fadd_rn(__fmul_rn(par, par), __fmul_rn(normal_of(w), sk));
            return dprev;
          },
          [&](int j, float x) {
            if (j == 0) {
              x0 = x;
              x0sq = x0 * x0;
            } else {
              const bool first = p[2 + j] != 0.0f;
              const float par = first ? x0sq : prev * prev;
              const float t = __fmul_rn(b, sq(x - par));
              if (first) s_first += t; else s_in += t;
            }
            prev = x;
          });
      return (__fmul_rn(-a, sq(x0 - p[2])) - s_first) - s_in;
    } else if constexpr (KIND == TARGET_HYPERCUBE) {
      const float w = k.k0;
      bool inside = true;   // & (no short circuit): no branch a coordinate
      cs.run(
          d, -1, none,
          [&](int i, uint32_t word) {
            return __fadd_rn(__fmul_rn(uniform_from_bits(word), w), sp[0]);
          },
          [&](int i, float x) { inside &= (x >= p[0]) & (x <= p[1]); });
      return inside ? p[2] : -INFINITY;
    } else {   // TARGET_NEAL_FUNNEL: [mu_v, sigma_v^2, mu_z]
      float v = 0.0f, dsc = 0.0f, ss = 0.0f;
      cs.run(
          d, -1, none,
          [&](int j, uint32_t w) {
            if (j == 0) {
              v = __fadd_rn(k.k0, __fmul_rn(k.k1, normal_of(w)));
              dsc = __fdiv_rn(expf(__fdiv_rn(v, 2.0f)), sb);
              return v;
            }
            return __fadd_rn(sp[2], __fmul_rn(dsc, normal_of(w)));
          },
          [&](int j, float x) {
            if (j > 0) {
              const float z = x - p[2];
              ss += __fmul_rn(z, z);
            }
          });
      const float prior = p[3] - __fmul_rn(0.5f, sq(v - p[0])) / p[1];
      if (d == 1) return prior;
      const float lik = (p[4] - __fmul_rn(p[5], v)) -
                        __fmul_rn(__fmul_rn(0.5f, expf(-v)), ss);
      return prior + lik;
    }
  }
}

// Words of a side's per-probe row in shared memory (made by the block at
// each probe's start): the scaled MVN's reciprocals 1 / (s_i sqrt(beta)),
// the full MVN's L_ij / sqrt(beta) up to the 16 bucket
__host__ __device__ constexpr int row_words(int d) {
  return KIND == TARGET_SCALED_MVN ? d : kFullTable ? d * d : 0;
}
// Words of a warp's rows in the full MVN's warp form: the sample's d words
// (z, then x - mean) and a chunk's y
__host__ __device__ constexpr int warp_row_words(int d) {
  return kFullWarp ? (d + 3) / 4 * 4 + kChunk : 0;
}
// Words of a block's dynamic shared memory: the two sides' rows | the
// mixtures' reciprocals of their divisors (d) | the warps' rows of the
// full MVN's warp form | the staged log-density parameters (`staged`
// words, 0 where they are read from global memory).  The rows come first,
// so that a kind's one row starts at the base (no register holds it)
__host__ __device__ constexpr int shared_words(int staged, int d) {
  return 2 * row_words(d) + (kQuotients ? d : 0) +
         kWarps * warp_row_words(d) + staged;
}

// The full MVN's warp form (kFullWarp; the header): the log-density of side
// sample `s` tempered at the table's beta, in every lane, from the side's
// table St (S_ij at j d + i, j <= i) and cov_inv^T (cT: cov_inv_ij at
// j d + i, bf16-rounded where bf16), in the warp's rows `row` (d words)
// and `yb` (kChunk).  x_i = mean_i + sum_{j <= i} z_j S_ij and y_i =
// sum_j cov_inv_ij (x_j - mean_j), each over j in order, and quad over i
// in order: the one-lane form's products and sums.
__device__ __forceinline__ float full_warp_lp(const Side& s, int d,
                                           const float* __restrict__ St,
                                           const float* __restrict__ cT,
                                           const float* __restrict__ p,
                                           const float* __restrict__ sp,
                                           float* row, float* yb, bool bf16) {
  const int lane = threadIdx.x & 31;
  __syncwarp();   // the rows' last readers are done
#pragma unroll 1
  for (int k = lane; 4 * k < d; k += 32) {   // z: Philox block k by lane k
    const uint4 b = s.block(k);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = 4 * k + w;
      if (i < d) {
        const float z = normal_of(philox_word(b, w));
        row[i] = bf16 ? bf16_round(z) : z;
      }
    }
  }
  __syncwarp();
  const int n_chunks = (d + kChunk - 1) / kChunk;
  // x - mean, from the last chunk of rows: chunk c reads z_j, j < its
  // last row, so its own rows' words may then take x_i - mean_i
#pragma unroll 1
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int i0 = c * kChunk;
    const int j_end = min(d, i0 + kChunk);
    float acc[kChunk / 32];
#pragma unroll
    for (int r = 0; r < kChunk / 32; ++r) acc[r] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < j_end; ++j) {
      const float z = row[j];
      const float* col = St + (size_t)j * d;
#pragma unroll
      for (int r = 0; r < kChunk / 32; ++r) {
        const int i = i0 + 32 * r + lane;
        if (i < d && j <= i) acc[r] = fmaf(z, __ldcg(col + i), acc[r]);
      }
    }
    __syncwarp();   // every lane's reads of this chunk's z are done
#pragma unroll
    for (int r = 0; r < kChunk / 32; ++r) {
      const int i = i0 + 32 * r + lane;
      if (i < d) row[i] = __fadd_rn(sp[i], acc[r]) - p[1 + i];
    }
    __syncwarp();
  }
  // y = cov_inv (x - mean) by chunks of rows; quad in lane 0, in order
  float quad = 0.0f;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const int i0 = c * kChunk;
    float acc[kChunk / 32];
#pragma unroll
    for (int r = 0; r < kChunk / 32; ++r) acc[r] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < d; ++j) {
      const float xc = bf16 ? bf16_round(row[j]) : row[j];
      const float* col = cT + (size_t)j * d;
#pragma unroll
      for (int r = 0; r < kChunk / 32; ++r) {
        const int i = i0 + 32 * r + lane;
        if (i < d) acc[r] = fmaf(col[i], xc, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kChunk / 32; ++r) yb[32 * r + lane] = acc[r];
    __syncwarp();
    if (lane == 0) {
      const int n = min(kChunk, d - i0);
      for (int k = 0; k < n; ++k) quad = fmaf(row[i0 + k], yb[k], quad);
    }
    __syncwarp();
  }
  return -0.5f * quad + p[0];
}

// The term of this lane's sample n (both lanes of the sample call it: lane
// j draws side 0 at bs, lane j + 16 side 1 at bc; k: the sides' constants;
// the full MVN's warp form reads the sides' lps from `lps`, side-major)
// as a double in lane j (0 where n >= N, and in lanes j + 16): min(1,
// exp((bc - bs)(lp(x*) - lp(x)))) in float32, a NaN staying NaN
// (torch.clamp_max's rule, not fminf's)
__device__ __forceinline__ double sample_term(
    int n, int N, int probe, const SideConst (&k)[2], int d,
    const float* __restrict__ p, const float* __restrict__ sp,
    const float* rs, const float* ys, const float* lps, bool fast, bool bf16,
    uint32_t k0, uint32_t k1) {
  const int side = (threadIdx.x >> 4) & 1;
  float lp = 0.0f;
  if (n < N) {
    const Side s{(uint32_t)n, kLadderTag | (uint32_t)side << 20,
                 (uint32_t)probe, k0, k1};
    const SideConst ks = k[side];
    const float* const r = rs + side * row_words(d);
    if constexpr (kFullWarp) {
      lp = __ldcg(lps + (size_t)side * N + n);
    } else if constexpr (kQuotients) {
      lp = fast ? side_lp<true>(s, d, ks, p, sp, r, ys, bf16)
                : side_lp<false>(s, d, ks, p, sp, r, ys, bf16);
    } else {
      lp = side_lp<false>(s, d, ks, p, sp, r, ys, bf16);
    }
  }
  const float other = __shfl_xor_sync(kFull, lp, 16);
  if (side || n >= N) return 0.0;
  const float bc = k[1].beta, bs = k[0].beta;
  const float log_r = __fmul_rn(__fsub_rn(bc, bs), __fsub_rn(lp, other));
  return (double)expf(isnan(log_r) ? log_r : fminf(log_r, 0.0f));
}

// The tree's levels over 16 elements, element j in lane j of each half
// warp (pairs (j, j + 8), (j, j + 4), (j, j + 2), (j, j + 1)): the sums in
// lanes 0 and 16
__device__ __forceinline__ double tree16(double v) {
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) v += __shfl_down_sync(kFull, v, w);
  return v;
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

// The search's state: each block runs the same search on the same
// estimates; block 0 writes the ladder and the trace (`write`)
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
// The ladder's last rung is beta_curr (the plain version's betas[-1]).
__device__ bool search_next(Search& s, const Settings& c, bool write,
                            double& bc, double& bs) {
  for (;;) {
    if (!s.in_rung) {
      if (s.failed ||
          !(s.beta_curr > c.beta_min + 1e-6 && s.t < c.max_T - 1)) {
        if (s.beta_curr > c.beta_min + 1e-5) {
          if (write) c.betas[s.t] = c.beta_min;
          ++s.t;
        }
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
      if (write) c.betas[s.t] = s.bstar;
      ++s.t;
      s.beta_curr = s.bstar;
    } else {
      s.failed = true;
    }
  }
}

// the estimate a of the last probe (step: c.pn_step[s.nu - 1])
__device__ __forceinline__ void search_take(Search& s, const Settings& c,
                                            bool write, double step,
                                            double a) {
  if (write && s.probe - 1 < c.trace_cap) c.trace[s.probe - 1] = a;
  s.ahat = a;
  s.found = fabs(a - c.rate) <= c.tol;
  if (!s.found) s.pn = s.pn + step * (a - c.rate);
  ++s.nu;
  ++s.it;
}

// The ctl workspace (kernels/ladder_build.py: CTL_WORDS): the blocks'
// arrivals, probe after probe (every block arrives once a probe, so probe
// p's tiles are summed when p times the grid have arrived), and, above
// kEveryTiles tiles a probe, the sums the last block to arrive publishes:
// probe p's in word p mod 4 (kUnset until then).  That block then unsets word
// p + 2 mod 4, probe p - 2's, which every block has read (all arrived at
// p); its arrival at p + 1 releases the store, and the last block of p + 1
// acquires it before publishing, so every block sees it before waiting on
// p + 2.
struct Control {
  unsigned long long arrived;
  unsigned long long total[4];
};
static_assert(sizeof(Control) <= kStampOffset, "ctl holds the control");
// a NaN no sum makes (its sign and payload): a probe's sum not yet published
constexpr unsigned long long kUnset = 0xfff4c0ffee0dd1ceull;

// atomicAdd(p, 1) with acquire and release semantics at gpu scope: the
// arrivals before
__device__ __forceinline__ unsigned long long arrive(unsigned long long* p) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
               : "=l"(old) : "l"(p) : "memory");
  return old;
}
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
// atomicInc(p, limit) with acquire and release semantics at gpu scope
__device__ __forceinline__ unsigned atom_inc_acq_rel(unsigned* p,
                                                     unsigned limit) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(limit) : "memory");
  return old;
}

#ifdef RWM_PT_LADDER_STAMPS
// A bench-only build (ladder_lib(..., stamps=True)): %globaltimer stamps
// of each probe p < trace_cap in the words after ctl's first kStampOffset
// bytes: word 0 the first probe's start, then 4 a probe: the last block's
// arrival (its work done); up to kEveryTiles tiles the latest block's
// wait for the arrivals over, above that the last block's sum published;
// the latest block's sum in hand; the latest block's search run (the next
// probe's start)
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(void* ctl, int cap, int probe, int j,
                                      bool latest) {
  if (probe - 1 < cap) {
    unsigned long long* w =
        (unsigned long long*)((char*)ctl + kStampOffset) + 1 +
        4 * (probe - 1) + j;
    if (latest) atomicMax(w, globaltimer()); else *w = globaltimer();
  }
}
#else
__device__ __forceinline__ void stamp(void*, int, int, int, bool) {}
#endif

struct Args {
  const float* params;    // log-density parameters (_build.kernel_target)
  const float* sparams;   // sampler parameters
  int n_params, stage, d, N, bf16;
  uint32_t key0, key1;
  double* sums;           // the tiles' sums, their partials, their counts
  Control* ctl;
  float* full;            // kFullWarp: S's tables (2 d^2), cov_inv^T (d^2),
                          // the sides' lps (2 N)
  double* out;            // [T, probes, betas (max_T), trace (trace_cap)]
  Settings set;
  Search init;
};

// The slots' sum of the probe's n_tiles tile sums (ladders.py::
// partition_sum's last two steps) by the whole block, in thread 0: slot t
// adds tiles t, t + 256, ... in order (eight loads in flight a thread),
// slot t = 16 j + u is lane j of unit u, so the slots' tree is tree16 over
// j, then over u.
__device__ __forceinline__ double slot_sum(const double* sums, int n_tiles,
                                           double (&red)[kUnits]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int r0 = 0; r0 < kUnits / kWarps; ++r0) {
    const int u = r0 * kWarps + w, t = (lane & 15) * kUnits + u;
    double acc = 0.0;
    if (lane < 16) {
      for (int r = t; r < n_tiles; r += 8 * kTile) {
        double q[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          q[i] = r + i * kTile < n_tiles ? __ldcg(sums + r + i * kTile) : 0.0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (r + i * kTile < n_tiles) acc += q[i];
      }
    }
    acc = tree16(acc);
    if (lane == 0) red[u] = acc;
  }
  __syncthreads();
  double v = 0.0;
  if (w == 0) v = tree16(lane < 16 ? red[lane] : 0.0);
  return v;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ladder_build_kernel(const __grid_constant__ Args a) {
  extern __shared__ float smem[];   // shared_words(staged, d)
  __shared__ double red[2][kUnits];
  __shared__ Search s;   // this block's copy of the search
  __shared__ SideConst sh_k[2];
  __shared__ int sh_done, sh_probe, sh_last;
  cg::grid_group grid = cg::this_grid();
  const float* p = a.params;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const Settings& c = a.set;
  const float* sp = a.sparams;
  const int d = a.d;
  float* const sh_row = smem;   // [side][i]
  float* const sh_ys = sh_row + 2 * row_words(d);
  // the full MVN's warp form: this warp's rows, the tables, the lps
  float* const wrow = sh_ys + (kQuotients ? d : 0) + w * warp_row_words(d);
  float* const s_params = sh_ys + (kQuotients ? d : 0) +
                          kWarps * warp_row_words(d);
  const size_t dd = (size_t)d * d;
  float* const f_table = kFullWarp ? a.full : nullptr;   // [side][j][i]
  float* const f_cinv_t = kFullWarp ? a.full + 2 * dd : nullptr;   // [j][i]
  float* const f_lps = kFullWarp ? a.full + 3 * dd : nullptr;   // [side][n]
  Control* g = a.ctl;
  const int n_tiles = (a.N + kTile - 1) / kTile;
  double* const sums2 = a.sums;   // (2, n_tiles): probe p's in half p & 1
  double* parts = a.sums + 2 * n_tiles;             // (16 n_tiles,)
  unsigned* counts = (unsigned*)(parts + n_tiles * kUnits);   // (n_tiles,)
  if (a.stage) {
    for (int i = tid; i < a.n_params; i += kThreads) s_params[i] = p[i];
    p = s_params;
  }
  // the mixtures' quotients by div_by where every divisor, mean and beta
  // keeps them normal (else __fdiv_rn)
  bool ok = c.beta_min >= 0x1p-60;
  if constexpr (kQuotients) {
    const float* sdiv = sp + (KIND == TARGET_THREE_MIXTURE ? 2 : 5);
    for (int i = tid; i < d; i += kThreads) {
      const float v = sdiv[i];
      ok &= fabsf(v) >= 0x1p-30f && fabsf(v) <= 0x1p30f;
      sh_ys[i] = __fdiv_rn(1.0f, v);
    }
    const int n_means = KIND == TARGET_THREE_MIXTURE ? 3 * d : 3;
    const float* means = sp + (KIND == TARGET_THREE_MIXTURE ? 2 + d : 2);
    for (int i = tid; i < n_means; i += kThreads)
      ok &= fabsf(means[i]) <= 0x1p30f;
  }
  if constexpr (kRolled) {
    for (int i = blockIdx.x * kThreads + tid; i < n_tiles;
         i += gridDim.x * kThreads)
      counts[i] = 0;
  }
  if constexpr (kFullWarp) {
    // cov_inv^T (its operands' bfloat16 rounding where bf16), read
    // coalesced by the rows' lanes
    const float* cinv = a.params + 1 + d;
    for (size_t e = (size_t)blockIdx.x * kThreads + tid; e < dd;
         e += (size_t)gridDim.x * kThreads) {
      const size_t i = e / d, j = e - i * d;
      const float v = cinv[e];
      f_cinv_t[j * d + i] = a.bf16 ? bf16_round(v) : v;
    }
  }
  const bool fast = __syncthreads_and(ok);
  const bool writer = blockIdx.x == 0;
  if (tid == 0) {
    s = a.init;
    if (writer) {
      c.betas[0] = 1.0;
      for (int t = 1; t < c.max_T; ++t) c.betas[t] = c.beta_min;
    }
    double bc = 0.0, bs = 0.0;
    const bool more = search_next(s, c, writer, bc, bs);
    sh_done = !more;
    sh_probe = s.probe;
    sh_k[0] = side_consts((float)bs, sp, d, a.bf16);
    sh_k[1] = side_consts((float)bc, sp, d, a.bf16);
    if (writer) {
      g->arrived = 0;
      for (int i = 0; i < 4; ++i) g->total[i] = kUnset;
      if (!more) {
        a.out[0] = s.t;
        a.out[1] = s.probe;
      }
#ifdef RWM_PT_LADDER_STAMPS
      *(unsigned long long*)((char*)a.ctl + kStampOffset) = globaltimer();
#endif
    }
  }
  grid.sync();
  int buf = 0;
  for (;;) {
    __syncthreads();   // the probe's constants, from thread 0's search
    if constexpr (KIND == TARGET_SCALED_MVN) {
      // the reciprocals 1 / (s_i sqrt(beta)) of both sides
      for (int i = tid; i < 2 * d; i += kThreads) {
        const int side = i >= d, j = i - side * d;
        sh_row[side * d + j] =
            __fdiv_rn(1.0f, __fmul_rn(sp[j], sh_k[side].sb));
      }
      __syncthreads();
    } else if constexpr (kFullTable) {
      // L_ij / sqrt(beta) of both sides (L: the sampler's words after the
      // mean)
      for (int i = tid; i < 2 * d * d; i += kThreads) {
        const int side = i >= d * d, j = i - side * d * d;
        sh_row[side * d * d + j] = __fdiv_rn(sp[d + j], sh_k[side].sb);
      }
      __syncthreads();
    }
    if (sh_done) break;
    const int probe = sh_probe;
    double* const tile_sums = sums2 + (probe & 1) * n_tiles;
    if constexpr (kFullWarp) {
      // each side's S_ij = L_ij / sqrt(beta), j <= i, column-major (the
      // sampler's L after the mean, read by rows); every block has
      // arrived at the last probe, so no warp reads the last table
      const float* L = sp + d;
      for (size_t e = (size_t)blockIdx.x * kThreads + tid; e < 2 * dd;
           e += (size_t)gridDim.x * kThreads) {
        const int side = e >= dd;
        const size_t f = e - side * dd, i = f / d, j = f - i * d;
        if (j <= i) {
          const float v = __fdiv_rn(L[f], sh_k[side].sb);
          f_table[side * dd + j * d + i] = a.bf16 ? bf16_round(v) : v;
        }
      }
      grid.sync();
      // the side-samples' lps, a warp each, grid-stride
      for (int u = blockIdx.x * kWarps + w; u < 2 * a.N;
           u += gridDim.x * kWarps) {
        const int side = u >= a.N, n = u - side * a.N;
        const Side sd{(uint32_t)n, kLadderTag | (uint32_t)side << 20,
                      (uint32_t)probe, a.key0, a.key1};
        const float lp = full_warp_lp(sd, d, f_table + side * dd, f_cinv_t,
                                      p, sp, wrow, wrow + warp_row_words(d)
                                      - kChunk, a.bf16);
        if (lane == 0) f_lps[u] = lp;
      }
      grid.sync();
    }
    if constexpr (!kRolled) {
      // whole tiles: sample 16 (lane & 15) + w of the tile in warp (unit) w
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int n = tile * kTile + (lane & 15) * kUnits + w;
        const double v = tree16(sample_term(n, a.N, probe, sh_k, d, p, sp,
                                            sh_row, sh_ys, f_lps, fast,
                                            a.bf16, a.key0, a.key1));
        if (lane == 0) red[buf][w] = v;
        __syncthreads();
        if (w == 0) {
          const double v = tree16(lane < 16 ? red[buf][lane] : 0.0);
          if (lane == 0) tile_sums[tile] = v;
        }
        buf ^= 1;
      }
    } else {
      // warp-units grid-stride: unit u holds samples 16 (lane & 15) +
      // u mod 16 of tile u / 16; the tile's last unit to finish sums its
      // 16 partials (levels 8 .. 1 of the tile's tree)
      for (int u = blockIdx.x * kWarps + w; u < n_tiles * kUnits;
           u += gridDim.x * kWarps) {
        const int tile = u / kUnits;
        const int n = tile * kTile + (lane & 15) * kUnits + u % kUnits;
        const double v = tree16(sample_term(n, a.N, probe, sh_k, d, p, sp,
                                            sh_row, sh_ys, f_lps, fast,
                                            a.bf16, a.key0, a.key1));
        int last = 0;
        if (lane == 0) {
          parts[u] = v;
          last = atom_inc_acq_rel(counts + tile, kUnits - 1) == kUnits - 1;
        }
        if (__shfl_sync(kFull, last, 0)) {
          __threadfence();   // each lane's loads after lane 0's acquire
          const double t =
              tree16(lane < 16 ? __ldcg(parts + tile * kUnits + lane) : 0.0);
          if (lane == 0) {
            tile_sums[tile] = t;
            __threadfence();
          }
        }
      }
      __syncthreads();
    }
    // the block's work is done: thread 0 arrives (an acquire-release add,
    // which releases the block's sums: written by this thread (unrolled),
    // or fenced by their writers before the block's barrier (rolled)).  Up
    // to kEveryTiles tiles every block waits for the grid's arrivals and
    // adds the slots; above, the last block to arrive adds them and
    // publishes the sum, for which the others wait.  A block runs ahead
    // into probe p + 1's half of the buffer; it writes this half again at
    // p + 2, after every block has arrived at p + 1, so after every load
    // of it here.
    const bool every = n_tiles <= kEveryTiles;
    double step = 0.0;   // the search's pn step, read before the wait
    if (tid == 0) {
      const unsigned long long all = (unsigned long long)probe * gridDim.x;
      const bool last = arrive(&g->arrived) + 1 == all;
      stamp(g, c.trace_cap, probe, 0, true);
      step = c.pn_step[s.nu - 1];
      if (every) {
        while (!last && ld_acquire(&g->arrived) < all) {
        }
        stamp(g, c.trace_cap, probe, 1, true);
      }
      sh_last = last;
    }
    __syncthreads();
    double total = 0.0;
    if (every || sh_last) {
      total = slot_sum(tile_sums, n_tiles, red[buf]);
      if (tid == 0 && !every) {
        stamp(g, c.trace_cap, probe, 1, false);
        st_release(&g->total[probe & 3],
                   (unsigned long long)__double_as_longlong(total));
        __stcg((long long*)&g->total[(probe + 2) & 3], (long long)kUnset);
      }
    } else if (tid == 0) {
      unsigned long long bits;
      while ((bits = ld_acquire(&g->total[probe & 3])) == kUnset) {
      }
      total = __longlong_as_double((long long)bits);
    }
    if (tid == 0) {
      stamp(g, c.trace_cap, probe, 2, true);
      search_take(s, c, writer, step, total / (double)a.N);
      double bc = 0.0, bs = 0.0;
      const bool more = search_next(s, c, writer, bc, bs);
      sh_done = !more;
      sh_probe = s.probe;
      sh_k[0] = side_consts((float)bs, sp, d, a.bf16);
      sh_k[1] = side_consts((float)bc, sp, d, a.bf16);
      if (writer && !more) {
        a.out[0] = s.t;
        a.out[1] = s.probe;
      }
      stamp(g, c.trace_cap, probe, 3, true);
    }
  }
}

// The launch's dynamic shared memory: shared_words of the staged
// parameters (n_params words where they take at most 32 KB)
int shared_bytes(int n_params, int d) {
  const int staged = 4 * n_params <= 32 * 1024 ? n_params : 0;
  return 4 * shared_words(staged, d);
}

// Blocks an SM holds at `shared` bytes of dynamic shared memory (the
// kernel's attribute set to them first, so that above 48 KB it may take
// them) and the SMs
int blocks_per_sm(int shared, int& per_sm, int& sms) {
  int dev = 0;
  cudaError_t e = cudaFuncSetAttribute(
      ladder_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
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
// parameters (device floats), d coordinates (the bucket's: kMinD <= d <=
// DMAX), N samples a side of a probe, the search's settings (JAX's
// _device_ladder, with the host builder's pn clamp and its exponent as the
// table pn_step of nu^pn_power, nu = 1 .. max_pn, computed by the host as
// the plain version computes it), the Philox key, bf16 the matmul
// operands' rounding, and the workspaces: sums (19 ceil(N / 256) doubles:
// the tile sums' two halves, their partials, their counts), ctl (256
// bytes), out (2 + max_T + trace_cap doubles: T, the probes, the ladder
// with beta_min in its unused slots, the first trace_cap probes'
// estimates), full (the full MVN above the 16 bucket: 3 d^2 + 2 N floats,
// the tables and the lps; else unused).  The grid: the blocks an SM holds
// times the SMs, at most the blocks the probe's tiles (units; the full
// MVN's warp form: its side-samples, a warp each) fill; one cooperative
// launch.
extern "C" int rwm_pt_ladder_build(
    const float* params, int n_params, const float* sparams, int d, int N,
    uint32_t key0, uint32_t key1, double rate, double beta_min, double tol,
    double initial_pn, const double* pn_step, double pn_lo, double pn_hi,
    int max_pn, double fail_tol, int max_T, int bf16,
    int trace_cap, double* sums, void* ctl, float* full, double* out,
    void* stream) {
  if (d < kMinD || d > DMAX || N < 1 || max_T < 2 || trace_cap < 0 ||
      (kFullWarp && full == nullptr))
    return (int)cudaErrorInvalidValue;
  const int stage = 4 * n_params <= 32 * 1024;
  const int shared = shared_bytes(n_params, d);
  int per_sm = 0, sms = 0;
  int e = blocks_per_sm(shared, per_sm, sms);
  if (e) return e;
  const long long n_tiles = (N + kTile - 1) / kTile;
  const long long work =
      kFullWarp ? (2LL * N + kWarps - 1) / kWarps
      : kRolled ? (n_tiles * kUnits + kWarps - 1) / kWarps : n_tiles;
  const long long room = (long long)per_sm * sms;
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
  a.sums = sums;
  a.ctl = (Control*)ctl;
  a.full = full;
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
      (void*)ladder_build_kernel, dim3((unsigned)(work < room ? work : room)),
      dim3(kThreads), args, shared, (cudaStream_t)stream);
}

// registers, local bytes, max threads a block, blocks an SM (at the
// launch's dynamic shared memory for n_params log-density words at d
// coordinates), SMs, those bytes
extern "C" int rwm_pt_ladder_build_info(int n_params, int d, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ladder_build_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  const int shared = shared_bytes(n_params, d);
  const int r = blocks_per_sm(shared, per_sm, sms);
  if (r) return r;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = attr.maxThreadsPerBlock;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = shared;
  return 0;
}
