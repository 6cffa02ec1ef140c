// Fused whole-run Random Walk Metropolis kernel for Hopper (sm_90a), one
// team of G lanes a chain, above 64 dimensions.
//
// Replaces: rwm_pt_tpu/kernels/pallas_rwm.py::_make_kernel (:259-321) and
// _make_record_kernel (:324-414) in their 64 < d <= 4092 configuration
// (the Pallas kernel runs at any d and only shrinks its VMEM block as d
// grows, :225-234).  csrc/fused_rwm.cu keeps d <= 64 at one thread a
// chain; above that a thread's proposal no longer fits its registers.
//
// Bound: operations, Philox's int32 work (chip_smoke.py::bound): 26 blocks
// of 60 int32 operations a (chain, step) at d = 100, 2.045e11 over the main
// shape (65,536 chains x 2000 steps), 12.2 ms at the card's int32 peak
// (SuperFunnel's likelihood binds instead, csrc/fused_pt.cu; its usual
// build fixes the dataset's shape, as csrc/fused_pt_warp.cu's does).
// Beside it the step's fixed work a chain (the butterflies of its sums,
// the uniform's broadcast, the accept, the Kahan sum, the counter) cost a
// whole warp's issue slots with one warp a chain (G = 32, the layout
// before teams), and 6 of its 32 lanes held no Philox block at d = 100.  A
// team of G lanes (csrc/warp.cuh) pays it once for 32 / G chains a warp,
// with log2 G butterfly levels, and each lane computes ceil(26 / G) blocks
// in a rolled loop; the proposal lives in the team's scratch row, so a
// small team keeps 48-56 registers.  The geometry (kernels/_build.py::
// choose_team) takes the smallest G whose grid fills the card (half a
// wave of blocks: G = 4 at the d = 100 main shape, 8 in the 256 bucket,
// and from 16,384 chains at d = 100) and keeps 16 warps an SM, and G = 32
// where a smaller team would leave the card short of warps, as the
// reference's 512-chain campaigns do.  The 512 and 1024 buckets'
// libraries hold G = 32 alone (kernels/_build.py::RWM_WARP_TEAMS: G = 16
// measured slower at every grid there).
//
// The 2048 and 4096 buckets: a chain's two rows (8 and 16 KB each) cap a
// block at 13 chains at d = 2000 and 6 at d = 4000, so one warp a chain
// left 8 and 6 warps an SM (under a 256-thread bound at d = 2000), each
// lane walking d / 128 Philox blocks with nothing to hide their latency.
// Their libraries hold G = 64 (and in the 4096 bucket 128) beside 32: a
// chain over W = G / 32 warps (csrc/warp.cuh's wide teams: named
// barriers, the warps' partial sums and the broadcast slots in kWideWords
// words a team at the start of shared memory), so the same rows hold 2-4x
// the warps (d = 2000: 13 chains of two warps, 26 warps an SM; d = 4000:
// 6 of four, 24).  G = 32 takes up to 512 threads there (13 chains at
// d = 2000).  A wide team's squared jump is summed by its first warp in
// G = 32's order (csrc/warp.cuh::jump_g32_order), so the Kahan ESJD equals
// G = 32's bit for bit wherever the trajectory does (the kinds that sum
// their lp in index order).  The three-row kinds (IIDGamma, IIDBeta, the
// full MVN, SuperFunnel's run-time shape) keep their terms row in global
// memory in these buckets (kGlobalTerms), in PT's pool of block slots
// (csrc/warp.cuh::claim_slot), so a chain's shared memory is its two rows;
// the terms are summed in index order from there, the same adds.
//
// One library per (proposal, draw, target kind, warp bucket DMAX = 128,
// 256, 512, 1024, 2048 or 4096 slots, d + 4 <= DMAX) from this source
// (-DRWM_PT_PROPOSAL, -DRWM_PT_NORMAL, -DRWM_PT_TARGET, -DRWM_PT_DMAX),
// holding the team sizes of RWM_PT_TEAMS (a mask of G values) as
// instantiations; every proposal and normal draw of csrc/fused_rwm.cu,
// int32 accepts after burn-in, the
// Kahan-summed squared jump, the runtime `rec` trace.  A block holds
// `chains` teams (kernels/_build.py::rwm_warp_geometry: at most
// kBlockThreads<G> threads, G chains a multiple of 32, fewer where a small
// C would leave SMs idle); each team's state row and scratch row
// (kTeamPitch words each) live in shared memory, with the parameters (when
// they take at most kParamsShared words; the full-covariance MVN's d x d
// precision above d ~ 110 is read through L2 instead) and Laplace's (d,)
// scales.  Global memory sees the initial and the final state only (and
// the pool's terms rows).  A warp whose teams all lie past C returns at
// once (a wide team's warps together), but in a build with a terms pool,
// whose block frees its slot after a last block barrier; a ragged warp's
// teams past C run on zeros and store nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=p -DRWM_PT_NORMAL=n
//        -DRWM_PT_TARGET=k -DRWM_PT_DMAX=D -DRWM_PT_TEAMS=m
//        [-DRWM_PT_SF_J=J -DRWM_PT_SF_K=K -DRWM_PT_SF_N=n
//         -DRWM_PT_SF_UNROLL=u]   (no --use_fast_math)
// Plain PyTorch version: fused_rwm.py::_run_rwm_fused_plain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp.cuh"

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

namespace {

constexpr int kMaxSharedBytes = 227 * 1024;   // a block's dynamic shared memory
constexpr int kProp = RWM_PT_PROPOSAL;
constexpr int kDraw = RWM_PT_NORMAL;
constexpr int kKind = RWM_PT_TARGET;
constexpr int kDmax = RWM_PT_DMAX;   // the warp bucket: d + 4 <= kDmax
static_assert(kDmax % 128 == 0, "warp buckets are multiples of 128 slots");
// The terms row of the kTermsRow kinds in global memory (the 2048 and 4096
// buckets), else in shared memory
constexpr bool kGlobalTerms = kTermsRow<kKind> && !kFixedDim && kDmax > 1024;
// rows a team keeps in shared memory
constexpr int kRows = kTeamRows<kKind> - (kGlobalTerms ? 1 : 0);

// A block's threads, the launch bound (one block an SM stated, as for the
// PT kernel, whose 256-bucket G = 32 instantiations spilled without it):
// 256 up to the 1024 bucket; in the 2048 and 4096 buckets 512 at G = 32
// (13 chains at d = 2000) and kWideThreads for the wide teams (13 chains
// of two warps at d = 2000, 7 of four at d = 4000 where a chain's rows
// leave room: the iso MVN's 6 and the two-row IIDGamma's 7)
constexpr int kWideThreads = 896;
template <int G>
constexpr int kBlockThreads = G > 32 ? kWideThreads : kDmax > 1024 ? 512 : 256;

__host__ __device__ constexpr int params_in_shared(int n_params) {
  return n_params <= kParamsShared ? n_params : 0;
}

// Words of dynamic shared memory: a wide team's exchange words
// (csrc/warp.cuh::kWideWords a team, G > 32 only; first, where team_words
// finds them) | state rows (chains x pitch, 16-byte aligned) | scratch
// rows (chains x pitch) | the kTermsRow kinds' terms rows (chains x
// pitch), but where kGlobalTerms | params (when they fit) | Laplace scales
// (d) | the block's slot of the terms pool (kGlobalTerms).
// kernels/_build.py::rwm_warp_shared_bytes mirrors this count.
__host__ __device__ constexpr size_t shared_words(int team, int pitch,
                                                  int n_params, int d,
                                                  int chains) {
  return (team > 32 ? (size_t)chains * kWideWords : 0) +
         (size_t)chains * kRows * pitch + params_in_shared(n_params) +
         (kProp == PROPOSAL_LAPLACE ? d : 0) + (kGlobalTerms ? 1 : 0);
}

template <int KIND, int DMAX, int G>
__global__ void __launch_bounds__(kBlockThreads<G>, 1)
    fused_rwm_warp_kernel(const float* __restrict__ params, int n_params,
                          float scale, float beta,
                          const float* __restrict__ x0,
                          const int* __restrict__ acc0,
                          const float* __restrict__ jump0,
                          float* __restrict__ x_out,
                          float* __restrict__ lp_out,
                          int* __restrict__ acc_out,
                          float* __restrict__ jump_out, int d, int C,
                          int total, int burn_in, int step0, uint32_t key0,
                          uint32_t key1, int replica0,
                          const float* __restrict__ lap,
                          float inv_d, float* __restrict__ rec,
                          int record_every, int record_chains,
                          float* __restrict__ terms,
                          unsigned* __restrict__ claim, int pool) {
  constexpr int NQ = DMAX / (4 * G);   // quads a lane holds in a row
  constexpr int kPitch = kTeamPitch<DMAX, G>;
  static_assert(DMAX % (4 * G) == 0, "a team's lanes split the bucket");
  static_assert(G <= 32 || !kFixedDim, "no wide team in a fixed shape");
  extern __shared__ float4 smem4[];
#ifdef RWM_PT_SF_N
  d = kFixedDim;   // a constant in a fixed-shape build
#endif
  const int nteams = blockDim.x / G;
  const int lane = threadIdx.x & 31;
  const int t = threadIdx.x & (G - 1);    // the lane in its team
  const int team = threadIdx.x / G;
  // [team][i]; after the wide teams' words
  float* s_x = (float*)smem4 + (G > 32 ? nteams * kWideWords : 0);
  float* s_row = s_x + nteams * kPitch;    // [team][i], scratch
  float* s_terms = s_row + nteams * kPitch;   // [team][i], kTermsRow
  float* s_params = s_x + nteams * kRows * kPitch;
  const int n_shared = params_in_shared(n_params);
  float* s_lap = s_params + n_shared;      // (d,) Laplace scales
  int* s_claim = (int*)(s_lap + (kProp == PROPOSAL_LAPLACE ? d : 0));
  if (kGlobalTerms && threadIdx.x == 0) *s_claim = claim_slot(claim, pool);
  for (int i = threadIdx.x; i < n_shared; i += blockDim.x)
    s_params[i] = params[i];
  if (kProp == PROPOSAL_LAPLACE)
    for (int i = threadIdx.x; i < d; i += blockDim.x) s_lap[i] = lap[i];
  __syncthreads();
  const int c = blockIdx.x * nteams + team;
  // the whole warp, when its first team lies past C (a wide team: all its
  // warps, whose barriers wait for each of them); not in a build with a
  // terms pool, whose block barrier at the end waits for every thread
  if (!kGlobalTerms &&
      blockIdx.x * nteams + (G > 32 ? team : (threadIdx.x >> 5) * (32 / G)) >=
          C)
    return;
  const bool valid = c < C;
#ifdef RWM_PT_SF_N
  // the fixed dataset always lies in shared memory (the launcher checks
  // its words): LDS, not generic loads
  const float* p = s_params;
#else
  const float* p = n_shared ? s_params : params;
#endif
  float* xs = s_x + team * kPitch;         // this chain's state row
  float* row = s_row + team * kPitch;
  // the team's terms row: in shared memory, or in the block's slot of the
  // global pool
  float* const trow =
      kGlobalTerms ? terms + ((size_t)*s_claim * nteams + team) * kPitch
                   : s_terms + team * kPitch;

#pragma unroll 1
  for (int k = 0; k < coord_trips<G, NQ>(d); ++k) {   // the lane's quads
    const int q = G * k + t;
    if (4 * q < d) {
      float4 v;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = 4 * q + w;
        set_word(v, w, (i < d && valid) ? x0[(size_t)i * C + c] : 0.0f);
      }
      row4(xs, q) = v;
    }
  }
  team_sync<G>();
  float lp = team_log_density<KIND, G, NQ>(xs, trow, d, p, lane);
  int acc = valid ? acc0[c] : 0;
  float esjd = valid ? jump0[c] : 0.0f, comp = 0.0f;   // Kahan sum

  for (int s = 0; s < total; ++s) {
    const int abs_step = step0 + s + 1;
    const bool post = abs_step > burn_in;
    float u_swap, part;
    const bool accept = team_mh_propose<KIND, kProp, kDraw, G, NQ>(
        xs, row, trow, lp, d, p, scale, s_lap, inv_d, beta, lane,
        c + replica0, 0, abs_step, key0, key1, u_swap, part);
    acc += (post && accept) ? 1 : 0;
    // the squared jump of an accept: summed by every team of a warp in
    // which one accepted (its shuffles need the whole warp; a wide team's
    // warps take this branch alike), a wide team's in G = 32's order by
    // its first warp, which has read the rows before the other warps copy
    // their quads of the proposal
    float jump = 0.0f;
    if (__any_sync(kFullMask, accept))
      jump = G > 32 ? jump_g32_order<G, NQ>(row, xs, d, t)
                    : team_sum<G>(part);
    if constexpr (G > 32)
      if (accept) team_sync<G>();
    if (accept) team_copy<G, NQ>(row, xs, d, t);   // the same in the team
    const float yk = ((post && accept) ? jump : 0.0f) - comp;
    const float tot = esjd + yk;
    comp = (tot - esjd) - yk;
    esjd = tot;
    if (rec != nullptr && c < record_chains && (s + 1) % record_every == 0) {
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

  team_sync<G>();   // every lane's last copy is in the row
  if (valid) {
    for (int i = t; i < d; i += G) x_out[(size_t)i * C + c] = xs[i];
    if (t == 0) {
      lp_out[c] = lp;
      acc_out[c] = acc;
      jump_out[c] = esjd;
    }
  }
  if constexpr (kGlobalTerms) {   // every team is done with its terms row
    __syncthreads();
    if (threadIdx.x == 0) free_slot(claim, *s_claim);
  }
}

using Kernel = decltype(&fused_rwm_warp_kernel<kKind, kDmax, 32>);

// The instantiation of team size G, when RWM_PT_TEAMS holds it
template <int G>
Kernel team_kernel() {
  if constexpr ((RWM_PT_TEAMS & G) != 0)
    return fused_rwm_warp_kernel<kKind, row_dmax<kDmax>(G), G>;
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

cudaError_t prepare(Kernel k, size_t shmem) {
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(k,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Attributes of the team-size-`team` kernel and of a launch of `chains`
// teams a block at d coordinates: out = {registers, maxThreadsPerBlock,
// local bytes a thread, dynamic shared bytes, blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor}.  csrc/fused_rwm.cu's C
// interface with the team size in front.
extern "C" int rwm_pt_fused_rwm_info(int team, int d, int chains,
                                     int n_params, int* out) {
  const Kernel k = kernel(team);
  if (k == nullptr || d < 1 || chains < 1 || n_params < 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  const size_t shmem =
      shared_words(team, pitch(team), n_params, d, chains) * sizeof(float);
  const int threads = team * chains;
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shmem;
  out[4] = 0;
  if (shmem > kMaxSharedBytes || threads > attr.maxThreadsPerBlock ||
      threads % 32 != 0 || !barriers_ok(team, threads))
    return 0;
  e = prepare(k, shmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], k,
                                                            threads, shmem);
}

// The run: csrc/fused_rwm.cu's arguments, `chains` teams a block, the team
// size, then the terms pool (kGlobalTerms builds: `pool` block slots of
// rows for every team of a block, their bitmask `claim` zeroed; else
// unread)
extern "C" int rwm_pt_fused_rwm(int kind, const float* params, int n_params,
                                float scale, float beta, const float* x0,
                                const int* acc0, const float* jump0,
                                float* x_out, float* lp_out, int* acc_out,
                                float* jump_out, int d, int C, int total,
                                int burn_in, int step0, uint32_t key0,
                                uint32_t key1, int replica0,
                                const float* lap, float inv_d,
                                float* rec, int record_every,
                                int record_chains, int chains, int team,
                                float* terms, unsigned* claim, int pool,
                                void* stream) {
  const Kernel k = kernel(team);
  const int threads = team * chains;
  if (k == nullptr || d < 1 || d + 4 > kDmax || C < 1 || total < 0 ||
      kind != kKind || chains < 1 || threads % 32 != 0 ||
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
  if (threads > attr.maxThreadsPerBlock || !barriers_ok(team, threads))
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem =
      shared_words(team, pitch(team), n_params, d, chains) * sizeof(float);
  if (shmem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  e = prepare(k, shmem);
  if (e != cudaSuccess) return (int)e;
  k<<<(C + chains - 1) / chains, threads, shmem, (cudaStream_t)stream>>>(
      params, n_params, scale, beta, x0, acc0, jump0, x_out, lp_out, acc_out,
      jump_out, d, C, total, burn_in, step0, key0, key1, replica0, lap,
      inv_d, rec, record_every, record_chains, terms, claim, pool);
  return (int)cudaGetLastError();
}
