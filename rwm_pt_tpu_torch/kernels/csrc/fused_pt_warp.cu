// Fused whole-run Parallel Tempering kernel for Hopper (sm_90a), one team
// of G lanes a (replica, rung), above 64 dimensions.
//
// Replaces: rwm_pt_tpu/kernels/pallas_pt.py::_make_kernel (:107-148) and
// _make_record_kernel (:151-222) with their body _pt_body_fn (:41-96), in
// their 64 < d <= 4092 configuration (the Pallas kernel runs at any d and
// only shrinks its VMEM block as d grows, :31-38).  csrc/fused_pt.cu keeps
// d <= 64 at one thread a (replica, rung); above that a thread's proposal
// no longer fits its registers.
//
// Bound: operations, Philox's int32 work (chip_smoke.py::bound): 26 blocks
// of 60 int32 operations a (replica, rung, step) at d = 100, 2.045e12 over
// the main shape (65,536 replicas x T = 10 x 2000 steps), 122.2 ms at the
// card's int32 peak (SuperFunnel's likelihood binds instead,
// csrc/fused_pt.cu, whose usual build here fixes the dataset's shape as
// the thread kernel's does: -DRWM_PT_SF_J, _K, _N, _UNROLL; d is a
// constant, two blocks an SM below G = 32 (kMinBlocks), each team size's
// rows are sized by d (csrc/warp.cuh::row_dmax) with no terms row, and csrc/warp.cuh::team_super_funnel_fixed
// reads the dataset from shared memory at compile-time offsets).  What
// cost time beside it with one warp a state
// (G = 32, the layout before teams) was the step's fixed work a state, paid
// by all 32 lanes for one state: the butterflies of its sums, the
// broadcasts of its uniforms, the accept, the Kahan sums and the counters;
// and 6 of the 32 lanes held no Philox block at d = 100.  A team of G
// lanes (csrc/warp.cuh) pays that work once for 32 / G states a warp, with
// log2 G butterfly levels, and each lane computes ceil(26 / G) blocks in a
// rolled loop; the proposal lives in the team's scratch row, not in
// registers, so a small team keeps 56-72 registers and the occupancy of one
// warp a state.  The geometry (kernels/_build.py::choose_team) takes the
// smallest G whose grid fills the card (half a wave of blocks: G = 4 at the
// d = 100 main shape, 8 in the 256 bucket, 16 in the 512 bucket) and keeps
// 16 warps an SM (in the 1024 bucket a state's 8 KB of rows leave G = 16
// ten: G = 32 there), and G = 32 for grids that leave the card short of
// warps.
//
// The 2048 and 4096 buckets: a state's two rows (8 and 16 KB each) cap an
// SM at a block of ten rung-teams at d = 2000 and five at d = 4000, so one
// warp a state left 5-10 warps an SM, each walking d / 128 Philox blocks a
// lane with nothing to hide their latency.  Their libraries hold G = 64
// (and in the 4096 bucket 128) beside 32: a state over W = G / 32 warps
// (csrc/warp.cuh's wide teams: named barriers, the warps' partial sums and the broadcast slots
// in kWideWords words a team at the start of shared memory), so the same
// rows hold 2-4x the warps (d = 2000, T = 10: G = 64, ten rung-teams of
// two warps, 20 warps an SM in one block; d = 4000: G = 128 over clusters
// of two blocks of five, 20 warps).  A wide team's cold-rung squared jump
// is summed by its first warp in G = 32's order (lane t's quads t + 32 k,
// then the butterfly), so the cold-jump sum equals G = 32's bit for bit
// wherever the trajectory does (the kinds that sum their lp in index
// order).  The three-row kinds (IIDGamma, IIDBeta, the full MVN,
// SuperFunnel's run-time shape) keep their terms row in global memory in
// these buckets and in every cluster build (kGlobalTerms): a row a team of
// a pool of (SMs x resident blocks) block slots, each block claiming a free
// slot of the pool's bitmask when it starts and freeing it when it ends
// (csrc/warp.cuh::claim_slot), so a state's shared memory is its two rows
// and IIDGamma at d = 2000 takes the one-block launch of the two-row
// kinds; the terms
// are summed in index order from there (16-byte loads), the same adds.
//
// One library per (proposal, draw, target kind, warp bucket DMAX = 128,
// 256, 512, 1024, 2048 or 4096 slots, d + 4 <= DMAX) from this source,
// holding the
// team sizes of RWM_PT_TEAMS (a mask of G values) as instantiations; the
// launcher takes G.  Everything of csrc/fused_pt.cu carries over at the
// team level: MH on
// every rung every step with int32 per-rung accepts after burn-in; on
// post-burn-in multiples of swap_every the sweep over the pairs (j, j+1)
// in the runtime order `order` (0: j = 0..T-2, the Pallas sweep; 1: even
// pairs then odd pairs, the scan engine's two half-sweeps), pair j's
// uniform from rung j's slot d+1, run by team lane 0 of the slot-0 team of
// each replica between two __syncthreads; "move" semantics (a swap changes
// the rung->slot map in shared memory, and the states reach their rungs'
// places when the run ends); an accept's store deferred past the sweep so
// the cold-rung jump across a pair-0 swap reads the old owner's pre-move
// row; Kahan sums of (dbeta)^2 over accepted swaps and of the cold rung's
// squared jump; per-rung scales s_sigma[t] (Normal std, UniformRadius
// radius) and Laplace's (T, d) table; the runtime `rec` trace of the cold
// chain.
//
// Layout.  A block is R replicas x T rung-teams of G lanes, team = slot R +
// replica, padded to whole warps with idle teams where R T G is not a
// multiple of 32 (kernels/_build.py::pt_warp_geometry chooses R and G; the
// launcher refuses what does not fit).  Each team's
// state row and scratch row (kTeamPitch words each) live in shared memory
// with the parameters (when at most kParamsShared words; else read through
// L2), the ladder and the sweep's words.  Launch bounds: G = 32 keeps one
// warp a state, 32 warps a block (T up to 32) in the 128 bucket, so at most
// 64 registers a thread, and 16 warps in the 256, 512 and 1024 buckets (T
// up to 16 at G = 32; 70-80 registers there); a team of G < 32 lanes is
// bound to 512 threads a block, so that T = 32 rungs fit at G = 8 (a cap
// of 64 registers, two such blocks an SM, measured slower) and at G = 16
// (the 1024 bucket's rows cap one block below: a ladder no block holds
// runs over a cluster, below); a wide team (G = 64, 128) to 640 threads,
// at most 96 registers (80-96 on an H100), ten or five rung-teams a block.
// Every loop over a lane's quads is rolled, so the registers do not grow
// with the bucket's quads a lane (8 at G = 32 in the 1024 bucket, 16 at
// G = 16).
// The ragged edge (C not a multiple of R) and the idle teams are masked:
// they run on zeros in their own rows and store nothing.
//
// The cluster build (-DRWM_PT_CLUSTER, libraries <variant>.<kind>.c<D>):
// a ladder whose T rung-teams one block does not hold (more threads than
// the launch bound, or rows beyond 227 KB: above 32 rungs at G = 16, 16
// at G = 32, fewer in the 1024 bucket) runs one replica's rung-teams over
// the k blocks of a thread-block cluster (k <= 8, the portable size;
// cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension), each block
// `slots` = ceil(T / k) of them (slots rank * slots .. of each of its R
// replicas; the last block's ragged slots are idle teams).  Rows never
// move: a block keeps its slots' state and scratch rows.  The sweep's
// words of a replica (lp and u per slot and pair, the two maps, the
// owner, the cold and beta-jump sums, the swap count) live in the
// cluster's rank-0 block, which holds slot 0 and so the sweeper; each
// team writes its lp and pair uniform there through distributed shared
// memory (cooperative_groups::this_cluster().map_shared_rank), the swap
// step's three barriers are cluster barriers (release / acquire), the
// sweeper runs the same loop in the same order on rank 0's words, and
// each team reads its new rung back from them.  The cold-rung jump across
// a pair-0 swap reads the old owner's pre-move row from the owner's block,
// which the third barrier keeps until it has been read.  Steps with no
// swap need no cluster barrier: each block counts its slots' accepts in a
// (T, R) table of its own, indexed by rung, summed over the cluster's
// blocks once at the end (integers: the order does not matter).
// Laplace's (T, d) scales are read through L2, not staged (200 KB at
// T = 50, d = 1000).  The teams' arithmetic is the one-block kernel's, so
// at one G the cluster build equals it bit for bit at any T both take.
// kernels/_build.py::pt_cluster_geometry chooses k and R.  Bound: the
// same int32 work as the one-block kernel (Philox's grows with T).  The
// sweep's words in other blocks are reached by 32-bit shared::cluster
// addresses (mapa.u32, ld / st.shared::cluster: a register an address
// where a mapped generic pointer takes two), made where they are used.
// G = 32's launch bound is 800 threads for the iso MVN and FullRosenbrock
// under the Normal proposal and the rule's draw (kClusterThreads: d = 1000,
// T = 50 in clusters of two blocks of 25).  The measuring build
// (-DRWM_PT_STAMPS, library ...c<D>s, kernels/fused_pt.py::swap_split)
// adds %globaltimer stamps of a swap step's parts as block thread 0 sees
// them (stamp_words).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=p -DRWM_PT_NORMAL=n
//        -DRWM_PT_TARGET=k -DRWM_PT_DMAX=D -DRWM_PT_TEAMS=m
//        [-DRWM_PT_CLUSTER=1 [-DRWM_PT_STAMPS=1]]
//        [-DRWM_PT_SF_J=J -DRWM_PT_SF_K=K -DRWM_PT_SF_N=n
//         -DRWM_PT_SF_UNROLL=u]   (no --use_fast_math)
// Plain PyTorch version: fused_pt.py::_run_pt_fused_plain.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp.cuh"

namespace cg = cooperative_groups;

#ifndef RWM_PT_PROPOSAL
#define RWM_PT_PROPOSAL PROPOSAL_NORMAL
#endif
#ifndef RWM_PT_NORMAL
#define RWM_PT_NORMAL DRAW_ICDF
#endif
#ifndef RWM_PT_TARGET
#define RWM_PT_TARGET TARGET_MVN_ISO
#endif
#ifndef RWM_PT_DMAX
#define RWM_PT_DMAX 128
#endif
#ifndef RWM_PT_TEAMS
#define RWM_PT_TEAMS 36   // G = 4 and G = 32
#endif
#ifdef RWM_PT_CLUSTER
constexpr bool kCluster = true;    // a replica's rungs over a cluster
#else
constexpr bool kCluster = false;   // a replica's rungs in one block
#endif

namespace {

constexpr int kProp = RWM_PT_PROPOSAL;
constexpr int kDraw = RWM_PT_NORMAL;
constexpr int kKind = RWM_PT_TARGET;
constexpr int kDmax = RWM_PT_DMAX;   // the warp bucket: d + 4 <= kDmax
constexpr int kMaxSharedBytes = 227 * 1024;     // a block's dynamic shared memory
// The terms row of the kTermsRow kinds in global memory (the 2048 and 4096
// buckets and every cluster build), else in shared memory
constexpr bool kGlobalTerms =
    kTermsRow<kKind> && !kFixedDim && (kCluster || kDmax > 1024);
// rows a team keeps in shared memory
constexpr int kRows = kTeamRows<kKind> - (kGlobalTerms ? 1 : 0);
static_assert(kDmax % 128 == 0, "warp buckets are multiples of 128 slots");

// The cluster build's launch bound at G = 32: 25 warps (d = 1000, T = 50
// over two blocks of 25 rung-teams) for the builds whose step fits the 72
// registers a thread that leaves (an SM's four register quarters hold 7
// warps each at 72, 6 at 80): the iso MVN and FullRosenbrock under the
// Normal proposal and the rule's draw (68-71 on an H100, no spill); 16
// for the others (IIDGamma and the uniform ball spilled 16 B at 72)
// (kernels/_build.py::CLUSTER_THREADS)
constexpr int kClusterThreads =
    (kKind == TARGET_MVN_ISO || kKind == TARGET_ROSENBROCK) &&
            kProp == PROPOSAL_NORMAL && kDraw == DRAW_LAX_ERFINV
        ? 800
        : 512;

// A block's threads, the launch bound: one warp a state (G = 32) takes 32
// warps in the 128 bucket and 16 above it, whose sweep's bookkeeping needs
// more registers (the 256 bucket's spilled at 64 and at 80), and
// kClusterThreads in every cluster build; teams of G < 32 lanes take 512
// threads, wide teams (G = 64, 128) 640 (ten rung-teams of 64 lanes at
// T = 10, five of 128; 96 registers)
template <int G>
constexpr int kBlockThreads =
    G > 32 ? 640
    : G == 32 && kCluster ? kClusterThreads
    : G == 32 && kDmax == 128 ? 1024 : 512;
// Blocks of that bound an SM: two for a build of fixed SuperFunnel shape
// below G = 32, which caps it at 64 registers (at d = 68, G = 4 ptxas
// took 65 without the cap: 14 replicas a block and 28 warps an SM in
// place of 16 and 32, and the full width ran 5 % slower; PERF.md §6),
// else one
template <int G>
constexpr int kMinBlocks = kFixedDim && G < 32 ? 2 : 1;

__host__ __device__ constexpr int params_in_shared(int n_params) {
  return n_params <= kParamsShared ? n_params : 0;
}

// Words of dynamic shared memory: a wide team's exchange words
// (csrc/warp.cuh::kWideWords a team, G > 32 only; first, where team_words
// finds them) | state rows (teams x pitch, 16-byte aligned; the block's
// teams, idle ones too) | scratch rows (teams x pitch) | the kTermsRow
// kinds' terms rows (teams x pitch), but where kGlobalTerms | params (when
// they fit)
// | beta, sigma | lp, u (per slot / pair) | cold sum, compensation, the
// sweep's beta-jump sum, its compensation, its swap count (per replica:
// kept in shared memory, not in the sweeping lane's registers) |
// slot_of_rung, rung_of_slot, accepts | the slot that held rung 0 before a
// sweep that moved it | the block's slot of the terms pool (kGlobalTerms) |
// Laplace scales (T, d), but in the cluster build,
// which reads them through L2 (every block of a cluster has the same
// layout; the sweep's words are used in rank 0's, the accepts in each
// block's own).  kernels/_build.py::pt_warp_shared_bytes mirrors this
// count.
__host__ __device__ constexpr size_t shared_words(int team, int pitch,
                                                  int n_params, int T, int d,
                                                  int R, int teams) {
  return (team > 32 ? (size_t)teams * kWideWords : 0) +
         (size_t)teams * kRows * pitch + params_in_shared(n_params) + 2 * T +
         2 * T * R + 5 * R + 3 * T * R + R + (kGlobalTerms ? 1 : 0) +
         (kProp == PROPOSAL_LAPLACE && !kCluster ? T * d : 0);
}

// The swap step's barrier: the block's, in the cluster build the cluster's
// (its arrive releases and its wait acquires the words written before it
// in any block's shared memory)
__device__ __forceinline__ void sweep_sync() {
  if constexpr (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The 32-bit shared::cluster address of shared word p in block `rank` of
// the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}

// A word of the sweep's shared memory, read and written: the block's own,
// in the cluster build rank 0's, through distributed shared memory
__device__ __forceinline__ float sweep_ld(const float* p) {
  if constexpr (kCluster) {
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];"
                 : "=f"(v) : "r"(cluster_addr(p, 0)) : "memory");
    return v;
  } else {
    return *p;
  }
}
__device__ __forceinline__ int sweep_ld(const int* p, int rank = 0) {
  if constexpr (kCluster) {
    int v;
    asm volatile("ld.shared::cluster.s32 %0, [%1];"
                 : "=r"(v) : "r"(cluster_addr(p, rank)) : "memory");
    return v;
  } else {
    return *p;
  }
}
__device__ __forceinline__ void sweep_st(float* p, float v) {
  if constexpr (kCluster)
    asm volatile("st.shared::cluster.f32 [%0], %1;"
                 :: "r"(cluster_addr(p, 0)), "f"(v) : "memory");
  else
    *p = v;
}
__device__ __forceinline__ void sweep_st(int* p, int v) {
  if constexpr (kCluster)
    asm volatile("st.shared::cluster.s32 [%0], %1;"
                 :: "r"(cluster_addr(p, 0)), "r"(v) : "memory");
  else
    *p = v;
}

#ifdef RWM_PT_STAMPS
// The measuring build's split of a swap step, as block thread 0 sees it,
// summed over the blocks in ns (kernels/fused_pt.py::SWAP_SPLIT): the MH
// move, the first cluster barrier, the sweep (rank 0) or the wait for it,
// the second barrier, the cold-rung jump, the third barrier; then the
// swap steps and the steps with no swap and their ns
constexpr int kStampWords = 9;
__device__ unsigned long long stamp_words[kStampWords];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// (the explicit one block an SM matters: without it ptxas took fewer
// registers and the 256 bucket's G = 32 kernels spilled)
template <int KIND, int DMAX, int G>
__global__ void __launch_bounds__(kBlockThreads<G>, kMinBlocks<G>)
    fused_pt_warp_kernel(
        const float* __restrict__ params, int n_params,
        const float* __restrict__ betas, const float* __restrict__ sigmas,
        const float* __restrict__ x0, const int* __restrict__ acc0,
        const int* __restrict__ swapacc0, const float* __restrict__ bj0,
        const float* __restrict__ cj0, float* __restrict__ x_out,
        float* __restrict__ lp_out, int* __restrict__ acc_out,
        int* __restrict__ swapacc_out, float* __restrict__ bj_out,
        float* __restrict__ cj_out, int d, int T, int C, int total,
        int burn_in, int swap_every, int step0, uint32_t key0,
        uint32_t key1, int replica0, int rung0,
        const float* __restrict__ lap, float inv_d,
        float* __restrict__ rec, int record_every, int record_chains,
        int order, int R, float* __restrict__ terms,
        unsigned* __restrict__ claim, int pool) {
  constexpr int NQ = DMAX / (4 * G);   // quads a lane holds in a row
  constexpr int kPitch = kTeamPitch<DMAX, G>;
  static_assert(DMAX % (4 * G) == 0, "a team's lanes split the bucket");
  static_assert(G <= 32 || !kFixedDim, "no wide team in a fixed shape");
  extern __shared__ float4 smem4[];
#ifdef RWM_PT_SF_N
  d = kFixedDim;   // a constant in a fixed-shape build
#endif
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x & (G - 1);    // the lane in its team
  const int tid = threadIdx.x / G;        // the team: slot R + replica
  const int nteams = blockDim.x / G;      // R T and the idle teams
  // the cluster build: this block is rank `rank` of a cluster of `nblk`,
  // and holds slots rank * slots .. of each replica of cluster `group`
  int rank = 0, nblk = 1, slots = T, group = blockIdx.x;
  bool live;                              // not an idle team
  int slot, cx;
  if constexpr (kCluster) {
    const cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    nblk = (int)cl.num_blocks();
    slots = (T + nblk - 1) / nblk;
    group = blockIdx.x / nblk;
    const int ls = tid / R;               // the slot in this block
    live = tid < R * slots && rank * slots + ls < T;
    slot = live ? rank * slots + ls : T - 1;
    cx = live ? tid - ls * R : 0;
    cl.sync();   // every block of the cluster runs before any reads another
  } else {
    live = tid < R * T;
    slot = live ? tid / R : T - 1;
    cx = live ? tid - slot * R : 0;
  }
  // the team's (slot, replica) word of the sweep's tables
  const int gid = kCluster ? slot * R + cx : tid;
  const int flat = threadIdx.x;           // for block-wide loads
  const int nthreads = blockDim.x;
  const int n_shared = params_in_shared(n_params);
  // [team][i]; after the wide teams' words
  float* s_x = (float*)smem4 + (G > 32 ? nteams * kWideWords : 0);
  float* s_row = s_x + nteams * kPitch;   // [team][i], scratch
  float* s_terms = s_row + nteams * kPitch;   // [team][i], kTermsRow
  float* s_params = s_x + nteams * kRows * kPitch;
  float* s_beta = s_params + n_shared;
  float* s_sigma = s_beta + T;
  float* s_lp = s_sigma + T;              // [slot][replica]
  float* s_u = s_lp + T * R;              // [pair][replica]
  float* s_cold = s_u + T * R;            // [replica]
  float* s_cc = s_cold + R;               // [replica]
  float* s_bj = s_cc + R;                 // [replica], the sweep's sums
  float* s_bc = s_bj + R;                 // [replica]
  int* s_swapacc = (int*)(s_bc + R);      // [replica]
  int* s_slot = s_swapacc + R;            // [rung][replica] -> slot
  int* s_rung = s_slot + T * R;           // [slot][replica] -> rung
  int* s_acc = s_rung + T * R;            // [rung][replica], this block's
  int* s_owner = s_acc + T * R;           // [replica]
  int* s_claim = s_owner + R;             // the terms pool's slot
  float* s_lap = (float*)(s_claim + (kGlobalTerms ? 1 : 0));   // [rung][i],
                                                          // Laplace only
  // (every team reads and writes the sweep's words through sweep_ld /
  // sweep_st: in the cluster build rank 0's, mapped where they are used)
  // Laplace's scales: staged, or in the cluster build read through L2
  const float* const lap_t = kCluster ? lap : s_lap;

  const int c = group * R + cx;
  const bool valid = live && c < C;
  float* xs = s_x + tid * kPitch;         // this team's state row
  float* row = s_row + tid * kPitch;
  if (kGlobalTerms && flat == 0) *s_claim = claim_slot(claim, pool);

  for (int i = flat; i < n_shared; i += nthreads) s_params[i] = params[i];
  for (int i = flat; i < T; i += nthreads) {
    s_beta[i] = betas[i];
    s_sigma[i] = sigmas[i];
  }
  if (kProp == PROPOSAL_LAPLACE && !kCluster)
    for (int i = flat; i < T * d; i += nthreads) s_lap[i] = lap[i];
  if constexpr (kCluster) {
    // this block's accepts: rung j's from acc0 where this block holds slot
    // j (rung j's at the start), else 0
    for (int i = flat; i < T * R; i += nthreads) {
      const int j = i / R, ci = group * R + (i - j * R);
      s_acc[i] = (j / slots == rank && ci < C) ? acc0[(size_t)j * C + ci]
                                               : 0;
    }
  }
  if (t == 0 && live) {
    sweep_st(s_slot + gid, slot);
    sweep_st(s_rung + gid, slot);
    if constexpr (!kCluster)
      s_acc[tid] = valid ? acc0[(size_t)slot * C + c] : 0;
    if (slot == 0) {   // (rank 0 in the cluster build)
      s_cold[cx] = valid ? cj0[c] : 0.0f;
      s_cc[cx] = 0.0f;
      s_bj[cx] = valid ? bj0[c] : 0.0f;
      s_bc[cx] = 0.0f;
      s_swapacc[cx] = valid ? swapacc0[c] : 0;
    }
  }

#pragma unroll 1
  for (int k = 0; k < coord_trips<G, NQ>(d); ++k) {   // the lane's quads
    const int q = G * k + t;
    if (4 * q < d) {
      float4 v;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 4 * q + w;
        set_word(v, w, (i < d && valid)
                           ? x0[((size_t)i * T + slot) * C + c] : 0.0f);
      }
      row4(xs, q) = v;
    }
  }
  __syncthreads();
  // the team's terms row: in shared memory, or in the block's slot of the
  // global pool
  float* const trow =
      kGlobalTerms ? terms + ((size_t)*s_claim * nteams + tid) * kPitch
                   : s_terms + tid * kPitch;
#ifdef RWM_PT_SF_N
  // the fixed dataset always lies in shared memory (the launcher checks
  // its words): LDS, not generic loads
  const float* p = s_params;
#else
  const float* p = n_shared ? s_params : params;
#endif
  float lp = team_log_density<KIND, G, NQ>(xs, trow, d, p, lane);
  int rung = slot;
  // team lane 0 of the slot-0 team runs the sweep of its replica
  const bool sweeper = live && slot == 0 && t == 0;

  for (int s = 0; s < total; ++s) {
    const int abs_step = step0 + s + 1;
    const bool post = abs_step > burn_in;
    const bool do_swap = post && (abs_step % swap_every == 0);
#ifdef RWM_PT_STAMPS
    unsigned long long st[7];
    st[0] = globaltimer();
#endif
    float u_swap, part;
    const bool accept = team_mh_propose<KIND, kProp, kDraw, G, NQ>(
        xs, row, trow, lp, d, p, s_sigma[rung], lap_t + rung * d, inv_d,
        s_beta[rung], lane, c + replica0, rung + rung0, abs_step, key0, key1,
        u_swap, part);
    if (t == 0 && live && post && accept) s_acc[rung * R + cx] += 1;

    int new_rung = rung, owner = -1;
    if (do_swap) {   // the same for every team of the block (the cluster)
      if (t == 0 && live) {
        sweep_st(s_lp + gid, lp);
        if (rung < T - 1) sweep_st(s_u + rung * R + cx, u_swap);
      }
#ifdef RWM_PT_STAMPS
      st[1] = globaltimer();
#endif
      sweep_sync();
#ifdef RWM_PT_STAMPS
      st[2] = globaltimer();
#endif
      if (sweeper) {   // (rank 0 in the cluster build: its own words)
        const int first = s_slot[cx];   // rung 0's slot before the sweep
        int moved = 0, swapacc = s_swapacc[cx];
        float bj = s_bj[cx], bc = s_bc[cx];
        const int n_even = T >> 1;     // pairs 0, 2, .. of 0..T-2
        for (int jj = 0; jj < T - 1; ++jj) {
          const int j = order == 0 ? jj
                        : (jj < n_even ? 2 * jj : 2 * (jj - n_even) + 1);
          const int a = s_slot[j * R + cx];
          const int b = s_slot[(j + 1) * R + cx];
          const float db = s_beta[j] - s_beta[j + 1];
          const float log_swap =
              db * (s_lp[b * R + cx] - s_lp[a * R + cx]);
          const bool sw = s_u[j * R + cx] < expf(log_swap);
          if (sw) {
            s_slot[j * R + cx] = b;
            s_slot[(j + 1) * R + cx] = a;
            swapacc += 1;
            if (j == 0) moved = 1;
          }
          const float yk = (sw ? __fmul_rn(db, db) : 0.0f) - bc;
          const float tot = bj + yk;
          bc = (tot - bj) - yk;
          bj = tot;
        }
        for (int j = 0; j < T; ++j)
          s_rung[s_slot[j * R + cx] * R + cx] = j;
        s_owner[cx] = moved ? first : -1;
        s_swapacc[cx] = swapacc;
        s_bj[cx] = bj;
        s_bc[cx] = bc;
      }
#ifdef RWM_PT_STAMPS
      st[3] = globaltimer();
#endif
      sweep_sync();
#ifdef RWM_PT_STAMPS
      st[4] = globaltimer();
#endif
      if (live) {
        new_rung = sweep_ld(s_rung + gid);
        // >= 0: rung 0 changed hands in this sweep
        owner = sweep_ld(s_owner + cx);
      }
    } else if (sweeper && s_bc[cx] != 0.0f) {
      // the sweep's compensation step with no swap accepted
      float bj = s_bj[cx], bc = s_bc[cx];
      for (int j = 0; j < T - 1; ++j) {
        const float yk = 0.0f - bc;
        const float tot = bj + yk;
        bc = (tot - bj) - yk;
        bj = tot;
      }
      s_bj[cx] = bj;
      s_bc[cx] = bc;
    }
    rung = new_rung;
    // cold-rung squared jump, Kahan-summed.  A team that took rung 0 in the
    // sweep holds its state after the move (its proposal or its state)
    // against the old owner's state before it; else the rung-0 team's
    // accepted proposal against its state (the proposal's part).  Every
    // team of a warp that holds such a team computes the sum (its shuffles
    // need the whole warp): across a swap with the rows (an accepted
    // proposal against the state, where the team did not take rung 0), else
    // from the parts; the rung-0 team keeps it.
    const bool cold = live && rung == 0;
    const bool took = cold && owner >= 0;
    float jump = 0.0f;
    if (do_swap && __any_sync(kFullMask, took)) {
      // the old owner's state row: in this block, or in the cluster build
      // in the block that holds its slot
      const float* prev = xs;
      if (took) {
        if constexpr (kCluster) {
          const int r = owner / slots;
          prev = cg::this_cluster().map_shared_rank(
              s_x + ((owner - r * slots) * R + cx) * kPitch, r);
        } else {
          prev = s_x + (owner * R + cx) * kPitch;
        }
      }
      jump = jump_g32_order<G, NQ>(accept ? row : xs, prev, d, t);
    } else if (__any_sync(kFullMask, cold && accept)) {
      // a wide team sums the rows in G = 32's order (part's order there)
      jump = G > 32 ? jump_g32_order<G, NQ>(row, xs, d, t)
                   : team_sum<G>(part);
    }
    if (cold && t == 0) {   // (the cluster build: rank 0's sums)
      const float sum = sweep_ld(s_cold + cx), comp = sweep_ld(s_cc + cx);
      const float yk = ((post && (took || accept)) ? jump : 0.0f) - comp;
      const float tot = sum + yk;
      sweep_st(s_cc + cx, (tot - sum) - yk);
      sweep_st(s_cold + cx, tot);
    }
#ifdef RWM_PT_STAMPS
    st[5] = globaltimer();
#endif
    if (do_swap) sweep_sync();   // the pre-move states have been read
    // a wide team's first warp has read the rows before its other warps
    // copy their quads of an accepted proposal (a swap step's barrier
    // above orders it there)
    if constexpr (G > 32)
      if (!do_swap && cold && accept) team_sync<G>();
#ifdef RWM_PT_STAMPS
    if (flat == 0) {
      const unsigned long long now = globaltimer();
      if (do_swap) {
        atomicAdd(&stamp_words[0], st[1] - st[0]);
        atomicAdd(&stamp_words[1], st[2] - st[1]);
        atomicAdd(&stamp_words[2], st[3] - st[2]);
        atomicAdd(&stamp_words[3], st[4] - st[3]);
        atomicAdd(&stamp_words[4], st[5] - st[4]);
        atomicAdd(&stamp_words[5], now - st[5]);
        atomicAdd(&stamp_words[6], 1ull);
      } else {
        atomicAdd(&stamp_words[7], 1ull);
        atomicAdd(&stamp_words[8], now - st[0]);
      }
    }
#endif
    if (accept) team_copy<G, NQ>(row, xs, d, t);
    if (rec != nullptr && cold && c < record_chains &&
        (s + 1) % record_every == 0) {   // the cold chain, after the sweep
      const size_t kr = (size_t)((s + 1) / record_every - 1);
#pragma unroll 1
      for (int k = 0; k < coord_trips<G, NQ>(d); ++k)   // the lane's words
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = 4 * (G * k + t) + w;
          if (i < d) rec[(kr * d + i) * record_chains + c] = xs[i];
        }
    }
  }

  sweep_sync();   // (the cluster build: every block's accepts are final)
  if (kGlobalTerms && flat == 0)   // the pool's slot is free again
    free_slot(claim, *s_claim);
  if (valid) {
    for (int i = t; i < d; i += G)
      x_out[((size_t)i * T + rung) * C + c] = xs[i];
    if (t == 0) {
      lp_out[(size_t)rung * C + c] = lp;
      int a = s_acc[gid];
      if constexpr (kCluster) {   // rung `slot`'s accepts over the blocks
        a = 0;
        for (int r = 0; r < nblk; ++r) a += sweep_ld(s_acc + gid, r);
      }
      acc_out[(size_t)slot * C + c] = a;
      if (slot == 0) {
        swapacc_out[c] = s_swapacc[cx];
        bj_out[c] = s_bj[cx];
        cj_out[c] = s_cold[cx];
      }
    }
  }
  // no block of a cluster leaves while another reads its accepts
  if constexpr (kCluster) cg::this_cluster().sync();
}

using Kernel = decltype(&fused_pt_warp_kernel<kKind, kDmax, 32>);

// The instantiation of team size G, when RWM_PT_TEAMS holds it
template <int G>
Kernel team_kernel() {
  if constexpr ((RWM_PT_TEAMS & G) != 0)
    return fused_pt_warp_kernel<kKind, row_dmax<kDmax>(G), G>;
  else
    return nullptr;
}

Kernel kernel(int team) {
  switch (team) {
    case 4: return team_kernel<4>();
    case 8: return team_kernel<8>();
    case 16: return team_kernel<16>();
    case 32: return team_kernel<32>();
    case 64: return team_kernel<64>();
    case 128: return team_kernel<128>();
    default: return nullptr;
  }
}

int pitch(int team) {
  return row_dmax<kDmax>(team) + (team < 32 ? team : 0);
}

// R T teams of `team` lanes, padded to whole warps with idle teams
// (kernels/_build.py::pt_block_threads)
int block_threads(int team, int R, int T) {
  return (team * R * T + 31) / 32 * 32;
}

cudaError_t prepare(Kernel k, size_t shmem) {
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// The slots a block holds of each replica's T: all T on one block, in the
// cluster build ceil(T / cluster) (a cluster of `cluster` blocks)
int block_slots(int T, int cluster) {
  return kCluster ? (T + cluster - 1) / cluster : T;
}

// Whether `cluster` is this build's: 0 (one block a ladder) in the
// one-block build, k >= 1 blocks a cluster in the cluster build (a k the
// card does not take, above the portable 8, is the launch's to refuse)
bool cluster_ok(int cluster) { return kCluster ? cluster >= 1 : cluster == 0; }

// The cluster build's launch configuration: `clusters` clusters of
// `cluster` blocks of `threads`
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int clusters, int cluster, int threads, size_t shmem,
                void* stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)clusters * (unsigned)cluster);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = shmem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace

// Attributes of a launch of team size `team`, R replicas x T rung-teams at
// d coordinates (the cluster build: R replicas a cluster of `cluster`
// blocks): out = {registers, maxThreadsPerBlock, local bytes a thread,
// dynamic shared bytes a block, blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, clusters the card holds at
// once by cudaOccupancyMaxActiveClusters (the cluster build; else 0)}.
// csrc/fused_pt.cu's C interface, whose first argument (runtime_r there)
// is the team size here, with the blocks a cluster after it.
extern "C" int rwm_pt_fused_pt_info(int team, int cluster, int d, int T,
                                    int R, int n_params, int* out) {
  const Kernel k = kernel(team);
  if (k == nullptr || !cluster_ok(cluster) || d < 1 || T < 1 || R < 1 ||
      n_params < 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  const int threads = block_threads(team, R, block_slots(T, cluster));
  const size_t shmem =
      shared_words(team, pitch(team), n_params, T, d, R, threads / team) *
      sizeof(float);
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shmem;
  out[4] = 0;
  out[5] = 0;
  if (shmem > kMaxSharedBytes || threads > attr.maxThreadsPerBlock ||
      !barriers_ok(team, threads))
    return 0;
  e = prepare(k, shmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], k, threads,
                                                    shmem);
  if (e != cudaSuccess || !kCluster) return (int)e;
  const ClusterLaunch l(1, cluster, threads, shmem, nullptr);
  e = cudaOccupancyMaxActiveClusters(&out[5], (const void*)k, &l.cfg);
  if (e != cudaSuccess) cudaGetLastError();   // leave no error behind
  return (int)e;
}

// The run: the arguments of csrc/fused_pt.cu's rwm_pt_fused_pt, whose
// runtime_r is the team size here, then the blocks a cluster (0: the
// one-block build's launch), then the terms pool (kGlobalTerms builds:
// `pool` block slots of rows for every team of a block, their bitmask
// `claim` zeroed; else unread)
extern "C" int rwm_pt_fused_pt(
    int kind, const float* params, int n_params, const float* betas,
    const float* sigmas, const float* x0, const int* acc0,
    const int* swapacc0, const float* bj0, const float* cj0, float* x_out,
    float* lp_out, int* acc_out, int* swapacc_out, float* bj_out,
    float* cj_out, int d, int T, int C, int total, int burn_in,
    int swap_every, int step0, uint32_t key0, uint32_t key1, int replica0,
    int rung0, const float* lap, float inv_d, float* rec, int record_every,
    int record_chains, int order, int R, int team, int cluster,
    float* terms, unsigned* claim, int pool, void* stream) {
  const Kernel k = kernel(team);
  if (k == nullptr || !cluster_ok(cluster) || d < 1 || d + 4 > kDmax ||
      T < 1 || C < 1 || total < 0 || swap_every < 1 || kind != kKind ||
      (order != 0 && order != 1) || R < 1 ||
      (kProp == PROPOSAL_LAPLACE && lap == nullptr) ||
      (rec != nullptr && (record_every < 1 || record_chains < 1 ||
                          record_chains > C)) ||
      (kGlobalTerms && (terms == nullptr || claim == nullptr || pool < 1)))
    return (int)cudaErrorInvalidValue;
#ifdef RWM_PT_SF_N
  // a fixed-shape build: params is the host's padded dataset
  // (kernels/_build.py::sf_team_pack), staged in shared memory
  if (d != kFixedDim || params == nullptr ||
      n_params != SuperFunnelTeamBuild::kWords)
    return (int)cudaErrorInvalidValue;
#endif
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  const int threads = block_threads(team, R, block_slots(T, cluster));
  if (threads > attr.maxThreadsPerBlock || !barriers_ok(team, threads))
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem =
      shared_words(team, pitch(team), n_params, T, d, R, threads / team) *
      sizeof(float);
  if (shmem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  e = prepare(k, shmem);
  if (e != cudaSuccess) return (int)e;
  if (kCluster) {
    const ClusterLaunch l((C + R - 1) / R, cluster, threads, shmem, stream);
    e = cudaLaunchKernelEx(
        &l.cfg, k, params, n_params, betas, sigmas, x0, acc0, swapacc0, bj0,
        cj0, x_out, lp_out, acc_out, swapacc_out, bj_out, cj_out, d, T, C,
        total, burn_in, swap_every, step0, key0, key1, replica0, rung0, lap,
        inv_d, rec, record_every, record_chains, order, R, terms, claim,
        pool);
    if (e != cudaSuccess) {   // a cluster the card refuses
      cudaGetLastError();
      return (int)e;
    }
    return (int)cudaGetLastError();
  }
  k<<<(C + R - 1) / R, threads, shmem, (cudaStream_t)stream>>>(
      params, n_params, betas, sigmas, x0, acc0, swapacc0, bj0, cj0, x_out,
      lp_out, acc_out, swapacc_out, bj_out, cj_out, d, T, C, total, burn_in,
      swap_every, step0, key0, key1, replica0, rung0, lap, inv_d, rec,
      record_every, record_chains, order, R, terms, claim, pool);
  return (int)cudaGetLastError();
}

// The measuring build's stamp words (kStampWords, ns and counts summed over
// the blocks since the last reset) into `out`, and zeroed when `reset`;
// cudaErrorInvalidValue in every other build
extern "C" int rwm_pt_fused_pt_stamps(unsigned long long* out, int reset) {
#ifdef RWM_PT_STAMPS
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && out != nullptr)
    e = cudaMemcpyFromSymbol(out, stamp_words, sizeof(stamp_words));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[kStampWords] = {};
    e = cudaMemcpyToSymbol(stamp_words, zero, sizeof(zero));
  }
  return (int)e;
#else
  (void)out;
  (void)reset;
  return (int)cudaErrorInvalidValue;
#endif
}
