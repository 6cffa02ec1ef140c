// A team of G lanes a (replica, rung) state: the lane layout, the
// Metropolis-Hastings step and the log-densities of the fused kernels above
// 64 dimensions (csrc/fused_pt_warp.cu, csrc/fused_rwm_warp.cu), the team
// form of csrc/mh.cuh and csrc/targets.cuh.  kernels/_build.py mirrors the
// layout in Python (warp_slot_owner, warp_blocks, bm_lanes, team_pitch,
// team_rows).
//
// Teams.  G (4, 8, 16, 32, 64 or 128, a template argument; a library
// instantiates those of kernels/_build.py::library_teams: 4 and 32 in the
// 128-slot bucket, 8 and 32 in the 256, 16 and 32 in the 512 and 1024,
// where RWM's take 32 alone, and 32 and 64 in the 2048 and 32, 64 and 128
// in the 4096) divides the warp into 32 / G
// aligned teams of G lanes; lane t = lane mod G of a team.  G = 32 is one
// warp a state.  A team's shuffles (__shfl_xor_sync with m < G,
// __shfl_sync with width G) never leave it, and every one of them is
// issued by all 32 lanes alike: the teams of a warp follow the same
// control flow up to their per-state branches (accept, the cold rung, a
// ragged edge), and no shuffle sits inside one.
//
// Wide teams.  G = 64 or 128 is W = G / 32 warps a state (team lane t =
// threadIdx.x mod G, team threadIdx.x / G of its block).  Its barrier
// (team_sync, where a narrower team has __syncwarp) is named barrier 1 +
// its team (bar.sync id, G; id 0 is __syncthreads'), so a block holds at
// most kMaxWideTeams of them; its exchange is kWideWords words a team at
// the start of the block's dynamic shared memory (team_words: the W warps'
// partial sums or all-flags, then the broadcast slots d, d + 1, d + 2,
// which the owner stores and every lane reads after a team barrier).  A
// sum is each warp's butterfly, then the W partials read by every lane in
// warp order between two team barriers: every lane still ends with the
// same float.
//
// Layout.  Coordinate i = 4q + w belongs to team lane q mod G, and so does
// Philox slot i: the lane computes block q = G k + t of the counter
// (q, replica, rung, abs_step) for each k with 4q <= d + 3, ceil(blocks /
// G) blocks a step, so the stream is the one the plain versions consume
// (kernels/draws.py) at every G.  The MH uniform (slot d), the swap uniform
// (d + 1) and the radius uniform (d + 2) are broadcast inside the team from
// the lane that owns them.
//
// Rows, no register arrays.  Each team has a state row (x) and a scratch
// row (the step's proposal y) of team_pitch(DMAX, G) words in shared
// memory; the IID kinds, the full-covariance MVN and SuperFunnel's
// run-time-shape build a third, for their terms (kTermsRow; a build with
// SuperFunnel's shape fixed sizes its rows by d, not by the bucket:
// team_super_funnel_fixed).  Every pass over a lane's quads is a rolled
// loop that reads and writes them there (16-byte accesses), so a lane's
// registers do not grow with its DMAX / (4 G) quads and a small G keeps
// the occupancy of one warp a state.  A step: one rolled loop computes each of the
// lane's Philox blocks and uses it up (its broadcast slots, and its
// proposal words, normals or Box-Muller uniforms into the scratch row);
// Box-Muller (pair k < h = ceil(d/2) computed by the lane of coordinate k,
// which alone reads slots k and h + k, or d + 3, and writes the cosine and
// the sine over them) and the uniform ball's direction then work on the
// row in place; after one team barrier every lane reads any word of the
// proposal (a Rosenbrock neighbour, HybridRosenbrock's x0, the quadratic
// form's columns) from the row.  The iso and scaled MVN (kOwnTerms) read
// none back: a lane adds its words' terms of the log-density where it
// writes them, from registers.  An accept copies the lane's quads of the
// scratch row to the state row, after anything that needs the pre-move
// state (PT's cold jump across a swap) has read it.  The row pitch is
// DMAX, plus G below G = 32, so that the 32 / G teams of a warp start on
// distinct banks (a word read by every lane of every team, as the in-order
// sums read, is conflict-free; a quarter-warp's 16-byte accesses lie in
// one team's row for G >= 8).
//
// Sums.  Every sum over the coordinates is a butterfly of log2 G levels of
// __shfl_xor_sync: at each level lane t adds a_t + a_{t^m} and lane t^m
// adds a_{t^m} + a_t, the same float, so every lane of a team ends with the
// bit-identical lp, log-ratio and accept decision, and every lane stores
// its part of a move or none does (a sum read in another order by each lane
// would let lanes disagree and tear the row).  The three kinds whose terms
// differ in sign or cancel (IIDGamma, IIDBeta, NealFunnel) add their terms
// in index order in every lane, the plain version's order
// (targets/base.py::sum0), which matters where lp is near 0, and so does
// SuperFunnel, whose groups' likelihoods the lanes compute in parallel
// (each group's in order: group j by team lane j mod G) into a terms row,
// or with its shape fixed into registers that every lane then reads in
// index order by __shfl_sync; the others sum
// in the butterfly's order, within the agreement gate's tolerance of the
// plain version (kernels/agreement.py).
#pragma once
#include "mh.cuh"

constexpr unsigned kFullMask = 0xffffffffu;

// Words of each of a team's rows
template <int DMAX, int G>
constexpr int kTeamPitch = DMAX + (G < 32 ? G : 0);

// The kinds whose log-density stages a row of its own: the IID kinds'
// terms and SuperFunnel's group likelihoods, summed in index order, and
// the full-covariance MVN's x - mean
template <int KIND>
constexpr bool kTermsRow = KIND == TARGET_IID_GAMMA ||
                           KIND == TARGET_IID_BETA ||
                           KIND == TARGET_MVN_FULL ||
                           KIND == TARGET_SUPER_FUNNEL;

// The kinds whose log-density sums a term of each coordinate's own word,
// the iso and the scaled MVN: team_mh_propose adds a lane's terms where it
// writes its proposal, so the step needs no __syncwarp and no second pass
// over the row for them (on an H100 that pass cost the d = 100 Laplace
// campaign 6 % at G = 32 and the d = 100 MVN main shape 11 % at G = 4,
// scripts/bench_torch_warp.py)
template <int KIND>
constexpr bool kOwnTerms = KIND == TARGET_MVN_ISO || KIND == TARGET_SCALED_MVN;

// Coordinate i's term of a kOwnTerms kind at word y
template <int KIND>
__device__ __forceinline__ float own_term(float y, int i, const float* p) {
  const float v = KIND == TARGET_MVN_ISO ? y - p[1 + i] : p[1 + i] * y;
  return v * v;
}

// A kOwnTerms kind's log-density from the sum s of its terms
template <int KIND>
__device__ __forceinline__ float own_terms_density(float s, const float* p) {
  if constexpr (KIND == TARGET_MVN_ISO)
    return -0.5f * s + p[0];
  else
    return p[0] - __fmul_rn(0.5f, s);
}

__device__ __forceinline__ void set_word(float4& v, int w, float f) {
  if (w == 0) v.x = f;
  else if (w == 1) v.y = f;
  else if (w == 2) v.z = f;
  else v.w = f;
}

__device__ __forceinline__ float4& row4(float* row, int q) {
  return reinterpret_cast<float4*>(row)[q];
}

// Trips of a rolled loop over the lane's quads that hold a coordinate
// (4 q < d), and over those that hold a slot of the step (4 q <= d + 3);
// one where the bucket gives a lane one quad
template <int G, int NQ>
__device__ __forceinline__ int coord_trips(int d) {
  return NQ == 1 ? 1 : ((d - 1) >> 2) / G + 1;
}
template <int G, int NQ>
__device__ __forceinline__ int block_trips(int d) {
  return NQ == 1 ? 1 : ((d + 3) >> 2) / G + 1;
}

// A wide team's exchange words (kernels/_build.py::WIDE_WORDS): words
// 0..W-1 the warps' partials, kSlotWord.. the broadcast slots
constexpr int kWideWords = 8;
constexpr int kSlotWord = 4;
// Wide teams a block: named barriers 1..15 (kernels/_build.py::
// WIDE_MAX_TEAMS)
constexpr int kMaxWideTeams = 15;

// Whether a block of `threads` has a named barrier for each of its teams
// of `team` lanes (kernels/_build.py::barriers_fit)
inline bool barriers_ok(int team, int threads) {
  return team <= 32 || threads / team <= kMaxWideTeams;
}

// This lane's team's exchange words (G > 32): kWideWords a team at the
// start of the block's dynamic shared memory, which a kernel of wide teams
// lays out so
template <int G>
__device__ __forceinline__ float* team_words() {
  static_assert(G > 32, "a team within a warp exchanges by shuffles");
  extern __shared__ float4 wide_smem[];
  return reinterpret_cast<float*>(wide_smem) + kWideWords * (threadIdx.x / G);
}

// The lane's place in its team from its warp lane: lane mod G within a
// warp, threadIdx.x mod G in a wide team
template <int G>
__device__ __forceinline__ int team_lane(int lane) {
  return (G > 32 ? (int)threadIdx.x : lane) & (G - 1);
}

// The team's barrier: __syncwarp within a warp, a named barrier of G
// threads across warps (with the memory ordering of both among the team)
template <int G>
__device__ __forceinline__ void team_sync() {
  if constexpr (G <= 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(threadIdx.x / G + 1), "n"(G)
                 : "memory");
}

// Butterfly sum over the team: every lane of it ends with the same float
// (a wide team: each warp's butterfly, then the warps' partials in order).
template <int G>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int m = (G < 32 ? G : 32) / 2; m > 0; m >>= 1)
    v += __shfl_xor_sync(kFullMask, v, m);
  if constexpr (G > 32) {
    float* w = team_words<G>();
    if ((threadIdx.x & 31) == 0) w[(threadIdx.x & (G - 1)) >> 5] = v;
    team_sync<G>();
    v = w[0];
#pragma unroll
    for (int i = 1; i < G / 32; ++i) v += w[i];
    team_sync<G>();   // every lane has read the partials
  }
  return v;
}

// Whether `pred` holds in every lane of the team of warp lane `lane`
template <int G>
__device__ __forceinline__ bool team_all(bool pred, int lane) {
  const unsigned b = __ballot_sync(kFullMask, pred);
  if constexpr (G == 32) {
    return b == kFullMask;
  } else if constexpr (G < 32) {
    const unsigned m = ((1u << G) - 1u) << (lane & ~(G - 1));
    return (b & m) == m;
  } else {
    float* w = team_words<G>();
    if (lane == 0)
      w[(threadIdx.x & (G - 1)) >> 5] = b == kFullMask ? 1.0f : 0.0f;
    team_sync<G>();
    bool all = true;
#pragma unroll
    for (int i = 0; i < G / 32; ++i) all &= w[i] != 0.0f;
    team_sync<G>();   // every lane has read the flags
    return all;
  }
}

// Philox block q of the step (those that hold a slot of 0..d+3; zeros
// past them)
__device__ __forceinline__ uint4 team_block(int q, int d, int replica,
                                            int rung, int abs_step,
                                            uint32_t key0, uint32_t key1) {
  return 4 * q <= d + 3
             ? philox_block(q, replica, rung, abs_step, key0, key1)
             : make_uint4(0u, 0u, 0u, 0u);
}

// The word of slot j (the same j in every lane) into w, from the team lane
// that holds it, while trip k of the block loop holds its block: a shuffle
// in the one k whose blocks hold slot j (a condition every lane of the
// warp takes alike)
template <int G>
__device__ __forceinline__ void take_slot(const uint4& b, int k, int j,
                                          uint32_t& w) {
  const int q = j >> 2;
  if (k == q / G)
    w = __shfl_sync(kFullMask, philox_word(b, j & 3), q % G, G);
}

// A wide team's take_slot: the lane that holds slot j stores its word in
// broadcast slot `at` of the team's words, which every lane reads after
// the next team barrier
template <int G>
__device__ __forceinline__ void put_slot(const uint4& b, int k, int j, int t,
                                         int at) {
  const int q = j >> 2;
  if (k == q / G && t == q % G)
    team_words<G>()[kSlotWord + at] = __uint_as_float(philox_word(b, j & 3));
}

// The lane's quads of row `from` into row `to`
template <int G, int NQ>
__device__ __forceinline__ void team_copy(const float* from, float* to,
                                          int d, int t) {
  const int n = coord_trips<G, NQ>(d);
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int q = G * k + t;
    if (4 * q < d) row4(to, q) = row_quad(from, q);
  }
}

// sum_i (a_i - b_i)^2 over i < d, every lane of the team the same float
template <int G, int NQ>
__device__ __forceinline__ float team_sq_jump(const float* a, const float* b,
                                              int d, int t) {
  const int n = coord_trips<G, NQ>(d);
  float s = 0.0f;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int q = G * k + t;
    if (4 * q < d) {
      const float4 aq = row_quad(a, q), bq = row_quad(b, q);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (4 * q + w < d) {
          const float dd = quad_word(aq, w) - quad_word(bq, w);
          s += dd * dd;
        }
      }
    }
  }
  return team_sum<G>(s);
}

// sum_i (a_i - b_i)^2 over i < d in G = 32's order at every team size: a
// wide team's first warp sums it as one warp a state does (lane t's quads
// t + 32 k, then the butterfly), so the sum equals G = 32's bit for bit
// wherever the rows do (the other warps' value is 0 and unused: only team
// lane 0 keeps it; the caller orders the rows' next writes after it with a
// team barrier); a narrower team's own team_sq_jump
template <int G, int NQ>
__device__ __forceinline__ float jump_g32_order(const float* a,
                                               const float* b, int d, int t) {
  if constexpr (G > 32)
    return t < 32 ? team_sq_jump<32, NQ * G / 32>(a, b, d, t) : 0.0f;
  else
    return team_sq_jump<G, NQ>(a, b, d, t);
}

// The terms rows of the kTermsRow kinds in global memory (the 2048 and
// 4096 buckets, PT's cluster build): a pool of `pool` block slots, each a
// row for every team of a block, and a claim bitmask (a bit a slot,
// zeroed by the wrapper, kernels/_build.py::terms_pool).  claim_slot
// claims a free slot for this block when it starts: at most SMs x
// resident blocks run at once, so one is free or is about to be freed by
// a block that has ended; free_slot gives it back when the block ends,
// after every team of the block is done with its row.
__device__ inline int claim_slot(unsigned* claim, int pool) {
  const int words = (pool + 31) >> 5;
  for (unsigned n = 0;; ++n) {
    const int w = (int)((blockIdx.x + n) % (unsigned)words);
    const int bits = pool - 32 * w < 32 ? pool - 32 * w : 32;
    const unsigned full = bits == 32 ? kFullMask : (1u << bits) - 1u;
    unsigned m = atomicOr(&claim[w], 0u);
    while ((m & full) != full) {
      const unsigned bit = 1u << (__ffs(~m) - 1);
      const unsigned prev = atomicOr(&claim[w], bit);
      if (!(prev & bit)) {
        __threadfence();   // the slot's last owner's writes come first
        return 32 * w + __ffs(bit) - 1;
      }
      m = prev | bit;
    }
  }
}
__device__ inline void free_slot(unsigned* claim, int slot) {
  __threadfence();
  atomicAnd(&claim[slot >> 5], ~(1u << (slot & 31)));
}

// sum_{i < d} row[i] in index order, read by every lane alike, a quad a
// load (a 16-byte aligned row, in shared or global memory): the same adds,
// in the same order, as a word at a time
__device__ __forceinline__ float row_sum_in_order(const float* row, int d) {
  float s = 0.0f;
  const int full = d >> 2;
  for (int q = 0; q < full; ++q) {
    const float4 v = reinterpret_cast<const float4*>(row)[q];
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  for (int i = 4 * full; i < d; ++i) s += row[i];
  return s;
}

// Box-Muller normals (csrc/mh.cuh::bm_normals' map) over the uniforms of
// every slot, which the team's lanes have written to its scratch row: the
// lane of coordinate i < h writes r cos over slot i and r sin over slot
// h + i (words it alone reads), so after the second team barrier word i of
// the row is normal i, i < d.
template <int G, int NQ>
__device__ __forceinline__ void team_bm_rows(float* row, int d, int t) {
  const int h = (d + 1) >> 1;
  const int n = coord_trips<G, NQ>(d);
  team_sync<G>();   // every slot's uniform is in the row
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = 4 * (G * k + t) + w;
      if (i < h) {
        const float u1 = fmaxf(row[i], 1e-7f);
        const int j2 = h + i < d ? h + i : d + 3;
        float r, rs, rc;
        box_muller(u1, row[j2], r, rs, rc);
        row[i] = rc;
        if (h + i < d) row[h + i] = rs;
      }
    }
  }
  team_sync<G>();   // every sine is in the row
}

// Parameters of up to this many words lie in a block's shared memory
// (kernels/_build.py::PARAMS_SHARED_MAX)
constexpr int kParamsShared = 12288;

#ifdef RWM_PT_SF_N
// SuperFunnel with the dataset's shape fixed at build time (-DRWM_PT_SF_J,
// _K, _N, _UNROLL; the library <variant>.super_funnel.j<J>k<K>n<N>u<U>.
// w<D>, kernels/_build.py::sf_tag): d is a constant, the rows are sized by
// it (row_dmax) and the dataset lies in shared memory in
// SuperFunnelTeamLayout's words
using SuperFunnelTeamBuild =
    SuperFunnelTeamLayout<RWM_PT_SF_J, RWM_PT_SF_K, RWM_PT_SF_N>;
constexpr int kFixedDim = SuperFunnelTeamBuild::kDim;
static_assert(SuperFunnelTeamBuild::kWords <= kParamsShared,
              "the fixed shape's dataset does not fit shared memory");
#else
constexpr int kFixedDim = 0;   // d at run time
#endif

// Rows a team keeps (kernels/_build.py::team_rows): the state and the
// proposal, and a third for the kTermsRow kinds but in a build of fixed
// shape, whose group sums pass by __shfl_sync
template <int KIND>
constexpr int kTeamRows = kTermsRow<KIND> && !kFixedDim ? 3 : 2;

// The words a row's quads span at team size G in warp bucket DMAX: the
// bucket, or in a build of fixed shape the smallest multiple of 4 G that
// holds d + 4 (kernels/_build.py::sf_team_dmax)
template <int DMAX>
__host__ __device__ constexpr int row_dmax(int team) {
  static_assert(kFixedDim + 4 <= DMAX, "the fixed shape's d exceeds DMAX");
  return kFixedDim ? (kFixedDim + 4 + 4 * team - 1) / (4 * team) * (4 * team)
                   : DMAX;
}

// Words 0..K of the observation at w (A-word loads; w A-word aligned)
template <int K, int A>
__device__ __forceinline__ void load_observation(const float* w,
                                                 float (&v)[K + 1]) {
#pragma unroll
  for (int a = 0; a < K + 1; a += A) {
    if constexpr (A == 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + a);
      v[a] = q.x;
      v[a + 1] = q.y;
      v[a + 2] = q.z;
      v[a + 3] = q.w;
    } else if constexpr (A == 2) {
      const float2 q = *reinterpret_cast<const float2*>(w + a);
      v[a] = q.x;
      v[a + 1] = q.y;
    } else {
      v[a] = w[a];
    }
  }
}

// SuperFunnel's log-density of the state in row y from the fixed dataset p
// (SuperFunnelTeamLayout<J, K, N>, in shared memory), every lane of the team
// the same float: the team form of csrc/targets.cuh::
// super_funnel_log_density_fixed, in its order.  Group j belongs to team
// lane j mod G, which reads its alpha and K betas from the row once (at
// compile-time offsets from the lane's first group), sums its N
// observations in order, U a trip (an observation's words one 16- or
// 8-byte load, sigma alpha exact so one FFMA adds it), and keeps the sum in
// a register; every lane then adds the J sums in index order, each taken
// from its lane by __shfl_sync (no terms row), and the priors' squares in
// index order, read as quads at compile-time offsets.  The taus are read
// alike by every lane, so `valid` holds team-wide; the shuffles sit
// outside the branch on it, which a warp's teams may take apart.
template <int J, int K, int N, int U, int G>
__device__ __forceinline__ float team_super_funnel_fixed(const float* y,
                                                         const float* p,
                                                         int lane) {
  using L = SuperFunnelTeamLayout<J, K, N>;
  constexpr int d = L::kDim;
  constexpr int m = J + J * K;             // mu_alpha; mu_beta from m + 1
  constexpr int kRounds = (J + G - 1) / G;   // groups t + G r a lane takes
  static_assert(U >= 1 && U <= N, "unroll by 1 .. N observations");
  const int t = lane & (G - 1);
  const bool valid = super_funnel_taus_valid(y[d - 2], y[d - 1]);
  float g[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) g[r] = 0.0f;
  if (valid) {
    const float* ya = y + t;               // alpha_t
    const float* yb = y + J + t * K;       // beta_t0
    const float* o = p + L::kHead + t * L::kStride;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (J % G == 0 || r + 1 < kRounds || t + G * r < J) {
        const float alpha = ya[G * r];
        float b[K];
#pragma unroll
        for (int k = 0; k < K; ++k) b[k] = yb[G * r * K + k];
        const float* og = o + G * r * L::kStride;
        float s = 0.0f;
#pragma unroll (U)
        for (int i = 0; i < N; ++i) {
          float w[K + 1];
          load_observation<K, L::kAccess>(og + i * (K + 1), w);
          float eta = fmaf(w[K], alpha, __fmul_rn(w[0], b[0]));
#pragma unroll
          for (int k = 1; k < K; ++k) eta += __fmul_rn(w[k], b[k]);
          s += super_funnel_signed_term(eta);
        }
        g[r] = s;
      }
    }
  }
  float ll = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j)
    ll += __shfl_sync(kFullMask, g[j / G], j % G, G);
  if (!valid) return -INFINITY;
  const float mu_a = y[m];
  float mb[K];
#pragma unroll
  for (int k = 0; k < K; ++k) mb[k] = y[m + 1 + k];
  float sa = 0.0f, sb = 0.0f, smb = 0.0f;
#pragma unroll
  for (int q = 0; q < (m + 3) / 4; ++q) {   // words 0 .. m - 1 by quads
    const float4 v = row_quad(y, q);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = 4 * q + w;
      if (i < J)
        sa += sq_rn(quad_word(v, w) - mu_a);
      else if (i < m)
        sb += sq_rn(quad_word(v, w) - mb[(i - J) % K]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) smb += sq_rn(mb[k]);
  return super_funnel_close(ll, sa, sb, smb, mu_a, y[d - 2], y[d - 1],
                            (float)J, (float)(J * K), p);
}

// The log-density of the state in row y (words past d unread),
// csrc/targets.cuh's formulas, every lane of the team the same float
// (SuperFunnel's likelihood too: its groups split over the lanes).
// Every word of y must be visible to the team (a team barrier after its
// last write); `trow` is the team's terms row (kTermsRow kinds).
template <int KIND, int G, int NQ>
__device__ __forceinline__ float team_log_density(const float* y,
                                                  float* trow, int d,
                                                  const float* p, int lane) {
  const int t = team_lane<G>(lane);
  const int nc = coord_trips<G, NQ>(d);
  if constexpr (KIND == TARGET_ROSENBROCK || KIND == TARGET_EVEN_ROSENBROCK) {
    const int n = d - 1;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < n) {
        const float4 yq = row_quad(y, q);
        const float next = y[4 * q + 4];   // 4 q + 4 <= d - 1 + 3 < DMAX
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * q + w;
          if (i < n) {
            const float xi = quad_word(yq, w);
            const float xn = w < 3 ? quad_word(yq, w + 1) : next;
            if constexpr (KIND == TARGET_ROSENBROCK) {
              const float tt = xn - xi * xi;
              s1 += p[1] * (tt * tt);
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
    }
    if constexpr (KIND == TARGET_ROSENBROCK)
      return -(team_sum<G>(s1) + team_sum<G>(s2));
    else
      return -team_sum<G>(s1);
  } else if constexpr (kOwnTerms<KIND>) {
    float s = 0.0f;
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < d) {
        const float4 yq = row_quad(y, q);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * q + w;
          if (i < d) s += own_term<KIND>(quad_word(yq, w), i, p);
        }
      }
    }
    return own_terms_density<KIND>(team_sum<G>(s), p);
  } else if constexpr (KIND == TARGET_MVN_FULL) {
    // x - mean in the terms row; lane t takes the columns j = t mod G of
    // every row of the precision matrix, so a team reads a row's
    // contiguous words (shared memory or L2, kernels/_build.py
    // params_shared_words)
    team_sync<G>();   // the terms row's last readers are done
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < d) {
        float4 v = row_quad(y, q);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * q + w;
          set_word(v, w, i < d ? quad_word(v, w) - p[1 + i] : 0.0f);
        }
        row4(trow, q) = v;
      }
    }
    team_sync<G>();
    const float* cinv = p + 1 + d;
    float acc = 0.0f;
    for (int i = 0; i < d; ++i) {
      float tt = 0.0f;
      for (int j = t; j < d; j += G) tt = fmaf(cinv[i * d + j], trow[j], tt);
      acc = fmaf(trow[i], tt, acc);
    }
    return -0.5f * team_sum<G>(acc) + p[0];
  } else if constexpr (KIND == TARGET_THREE_MIXTURE) {
    const float* s = p + 5;
    const float* mu = p + 5 + d;
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < d) {
        const float4 yq = row_quad(y, q);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * q + w;
          if (i < d) {
            const float v = s[i] * quad_word(yq, w);
            const float e0 = v - mu[i], e1 = v - mu[d + i],
                        e2 = v - mu[2 * d + i];
            q0 += e0 * e0;
            q1 += e1 * e1;
            q2 += e2 * e2;
          }
        }
      }
    }
    q0 = team_sum<G>(q0);
    q1 = team_sum<G>(q1);
    q2 = team_sum<G>(q2);
    const float c0 = (__fmul_rn(-0.5f, q0) - p[1]) + p[2];
    const float c1 = (__fmul_rn(-0.5f, q1) - p[1]) + p[3];
    const float c2 = (__fmul_rn(-0.5f, q2) - p[1]) + p[4];
    const float m = fmaxf(fmaxf(c0, c1), c2);
    const float m0 = isfinite(m) ? m : 0.0f;
    return (logf(expf(c0 - m0) + expf(c1 - m0) + expf(c2 - m0)) + m0) + p[0];
  } else if constexpr (KIND == TARGET_ROUGH_CARPET) {
    const float* s = p + 7;
    float total = 0.0f;
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < d) {
        const float4 yq = row_quad(y, q);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * q + w;
          if (i < d) {
            const float v = s[i] * quad_word(yq, w);
            const float a0 = p[1] - __fmul_rn(0.5f, sq(v - p[4]));
            const float a1 = p[2] - __fmul_rn(0.5f, sq(v - p[5]));
            const float a2 = p[3] - __fmul_rn(0.5f, sq(v - p[6]));
            const float m = fmaxf(fmaxf(a0, a1), a2);
            const float m0 = isfinite(m) ? m : 0.0f;
            total +=
                (m + logf(expf(a0 - m0) + expf(a1 - m0) + expf(a2 - m0))) -
                0.918938533204672742f;   // log sqrt(2 pi)
          }
        }
      }
    }
    return team_sum<G>(total) + p[0];
  } else if constexpr (KIND == TARGET_HYBRID_ROSENBROCK) {
    const float a = p[0], b = p[1];
    const float x0 = y[0];
    const float x0sq = x0 * x0;
    float s_first = 0.0f, s_in = 0.0f;
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < d) {
        const float4 yq = row_quad(y, q);
        const float before = q > 0 ? y[4 * q - 1] : 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * q + w;
          if (i >= 1 && i < d) {
            const bool first = p[2 + i] != 0.0f;
            const float prev = w > 0 ? quad_word(yq, w - 1) : before;
            const float par = first ? x0sq : prev * prev;
            const float tt = __fmul_rn(b, sq(quad_word(yq, w) - par));
            if (first) s_first += tt; else s_in += tt;
          }
        }
      }
    }
    return (__fmul_rn(-a, sq(x0 - p[2])) - team_sum<G>(s_first)) -
           team_sum<G>(s_in);
  } else if constexpr (KIND == TARGET_HYPERCUBE) {
    bool inside = true;
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < d) {
        const float4 yq = row_quad(y, q);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (4 * q + w < d)
            inside &= (quad_word(yq, w) >= p[0]) & (quad_word(yq, w) <= p[1]);
      }
    }
    return team_all<G>(inside, lane) ? p[2] : -INFINITY;
  } else if constexpr (KIND == TARGET_IID_GAMMA || KIND == TARGET_IID_BETA) {
    bool valid = true;
    team_sync<G>();   // the terms row's last readers are done
#pragma unroll 1
    for (int k = 0; k < nc; ++k) {
      const int q = G * k + t;
      if (4 * q < d) {
        const float4 yq = row_quad(y, q);
        float4 tq;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          float term = 0.0f;
          if (4 * q + w < d) {
            const float xi = quad_word(yq, w);
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
          set_word(tq, w, term);
        }
        row4(trow, q) = tq;
      }
    }
    team_sync<G>();
    const float s = row_sum_in_order(trow, d);
    if (!team_all<G>(valid, lane)) return -INFINITY;
    return KIND == TARGET_IID_GAMMA ? s - p[2] : s + p[2];
  } else if constexpr (KIND == TARGET_SUPER_FUNNEL) {
#ifdef RWM_PT_SF_N
    return team_super_funnel_fixed<RWM_PT_SF_J, RWM_PT_SF_K, RWM_PT_SF_N,
                                   RWM_PT_SF_UNROLL, G>(y, p, lane);
#else
    // group j's likelihood by team lane j mod G into word j of the terms
    // row; then every lane adds the groups and the priors' squares in
    // index order, the plain version's order (terms of both signs: lp near
    // 0 rounds as the plain lp does).  The taus are read alike by every
    // lane, so `valid` holds team-wide.
    const auto x = [y](int i) { return y[i]; };
    const bool valid = super_funnel_taus_valid(y[d - 2], y[d - 1]);
    team_sync<G>();   // the terms row's last readers are done
    if (valid)
      for (int j = t; j < (int)p[0]; j += G)
        trow[j] = super_funnel_group(x, j, p);
    team_sync<G>();
    if (!valid) return -INFINITY;
    return super_funnel_valid(x, [trow](int j) { return trow[j]; }, d, p);
#endif
  } else {   // TARGET_NEAL_FUNNEL: the squares in index order from k = 1
    const float v = y[0];
    const float prior = p[3] - __fmul_rn(0.5f, sq(v - p[0])) / p[1];
    if (d == 1) return prior;
    float ss = 0.0f;
    for (int i = 1; i < d; ++i) {
      const float z = y[i] - p[2];
      ss += __fmul_rn(z, z);
    }
    const float lik = (p[4] - __fmul_rn(p[5], v)) -
                      __fmul_rn(__fmul_rn(0.5f, expf(-v)), ss);
    return prior + lik;
  }
}

// Propose from the state in the team's state row xs into its scratch row
// and test it (csrc/mh.cuh::mh_propose in team form).  Returns the
// decision, the same in every lane of the team; lp becomes the proposal's
// log-density on an accept; u_swap is the uniform of slot d + 1 (PT's pair
// uniform); jump the lane's part of sum_i (y_i - x_i)^2, added in
// team_sq_jump's order (team_sum of it is the squared jump); a kOwnTerms
// kind's lp terms are added in the same order beside it, as
// team_log_density adds them.  The state row is left as it was; on an accept the caller copies the scratch row's
// words 0..d-1 to it.  The loop over the lane's
// blocks is kept rolled (one inlined copy of the normal draw, however many
// blocks a lane has) and uses each block up there: the broadcast slots it
// holds, and its proposal words (Normal, Laplace), normals (UniformRadius)
// or uniforms (Box-Muller) into the scratch row.
template <int KIND, int PROP, int DRAW, int G, int NQ>
__device__ __forceinline__ bool team_mh_propose(
    const float* xs, float* row, float* trow, float& lp, int d,
    const float* p, float scale, const float* lap, float inv_d, float beta,
    int lane, int replica, int rung, int abs_step, uint32_t key0,
    uint32_t key1, float& u_swap, float& jump) {
  constexpr bool kBM = PROP != PROPOSAL_LAPLACE && DRAW == DRAW_BM;
  constexpr bool kUR = PROP == PROPOSAL_UNIFORM_RADIUS;
  const int t = team_lane<G>(lane);
  const int nb = block_trips<G, NQ>(d);
  uint32_t w_mh = 0u, w_sw = 0u, w_r = 0u;
  float sj = 0.0f, slp = 0.0f;   // the jump's and the lp's parts
  team_sync<G>();   // the scratch row's (and slots') last readers are done
#pragma unroll 1
  for (int k = 0; k < nb; ++k) {
    const int q = G * k + t;
    const uint4 b = team_block(q, d, replica, rung, abs_step, key0, key1);
    if constexpr (G > 32) {
      put_slot<G>(b, k, d, t, 0);
      put_slot<G>(b, k, d + 1, t, 1);
      if constexpr (kUR) put_slot<G>(b, k, d + 2, t, 2);
    } else {
      take_slot<G>(b, k, d, w_mh);
      take_slot<G>(b, k, d + 1, w_sw);
      if constexpr (kUR) take_slot<G>(b, k, d + 2, w_r);
    }
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
          if constexpr (!kUR) {
            const float dd = out - quad_word(xq, w);
            sj += dd * dd;
            if constexpr (kOwnTerms<KIND>) slp += own_term<KIND>(out, i, p);
          }
        }
        set_word(v, w, out);
      }
    }
    if (4 * q <= d + 3) row4(row, q) = v;
  }
  if constexpr (G > 32) {   // the broadcast slots, from the team's words
    team_sync<G>();
    const float* w = team_words<G>() + kSlotWord;
    w_mh = __float_as_uint(w[0]);
    w_sw = __float_as_uint(w[1]);
    if constexpr (kUR) w_r = __float_as_uint(w[2]);
  }
  if constexpr (kBM) team_bm_rows<G, NQ>(row, d, t);   // the normals
  if constexpr (kBM || kUR) {
    // the proposal from the normals, over the lane's quads in place:
    // x + n scale, or the uniform ball's x + n / ||n|| r
    const int nc = coord_trips<G, NQ>(d);
    float f = scale;
    if constexpr (kUR) {
      float nrm2 = 0.0f;
#pragma unroll 1
      for (int k = 0; k < nc; ++k) {
        const int q = G * k + t;
        if (4 * q < d) {
          const float4 nq = row_quad(row, q);
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (4 * q + w < d) nrm2 += quad_word(nq, w) * quad_word(nq, w);
        }
      }
      nrm2 = team_sum<G>(nrm2);
      f = scale * expf(logf(uniform_from_bits(w_r)) * inv_d);
      const float den = fmaxf(sqrtf(nrm2), 1e-12f);
#pragma unroll 1
      for (int k = 0; k < nc; ++k) {
        const int q = G * k + t;
        if (4 * q < d) {
          const float4 xq = row_quad(xs, q), nq = row_quad(row, q);
          float4 v;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            float out = 0.0f;
            if (4 * q + w < d) {
              out = quad_word(xq, w) + __fmul_rn(quad_word(nq, w) / den, f);
              const float dd = out - quad_word(xq, w);
              sj += dd * dd;
              if constexpr (kOwnTerms<KIND>)
                slp += own_term<KIND>(out, 4 * q + w, p);
            }
            set_word(v, w, out);
          }
          row4(row, q) = v;
        }
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < nc; ++k) {
        const int q = G * k + t;
        if (4 * q < d) {
          const float4 xq = row_quad(xs, q), nq = row_quad(row, q);
          float4 v;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            float out = 0.0f;
            if (4 * q + w < d) {
              out = quad_word(xq, w) + __fmul_rn(quad_word(nq, w), f);
              const float dd = out - quad_word(xq, w);
              sj += dd * dd;
              if constexpr (kOwnTerms<KIND>)
                slp += own_term<KIND>(out, 4 * q + w, p);
            }
            set_word(v, w, out);
          }
          row4(row, q) = v;
        }
      }
    }
  }
  jump = sj;
  u_swap = uniform_from_bits(w_sw);
  const float u = uniform_from_bits(w_mh);
  float lp_prop;
  if constexpr (kOwnTerms<KIND>) {
    lp_prop = own_terms_density<KIND>(team_sum<G>(slp), p);
  } else {
    team_sync<G>();   // the proposal is in the row
    lp_prop = team_log_density<KIND, G, NQ>(row, trow, d, p, lane);
  }
  const float log_ratio = beta * (lp_prop - lp);
  const bool accept = (log_ratio > 0.0f) || (u < expf(log_ratio));
  if (accept) lp = lp_prop;
  return accept;
}
