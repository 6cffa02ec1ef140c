// Fused whole-run Parallel Tempering kernel for Hopper (sm_90a).
//
// Replaces rwm_pt_tpu/kernels/pallas_pt.py::_make_kernel (:107-148) and
// _make_record_kernel (:151-222) with their body _pt_body_fn (:41-96), the
// Pallas kernels behind run_pt_pallas, with the Normal, Laplace and
// UniformRadius increments and the ICDF, Box-Muller or draw-study normal
// draw (csrc/mh.cuh; per-rung scales as pallas_pt.py:307-320).  One library
// is built per (proposal, draw, target kind, register bucket DMAX = 8, 16,
// 32 or 64) from this one source (-DRWM_PT_PROPOSAL, -DRWM_PT_NORMAL,
// -DRWM_PT_TARGET, -DRWM_PT_DMAX, and -DRWM_PT_MINBLOCKS, the blocks of
// kBlockThreads threads an SM must hold, which caps the registers of the
// 32-replica instantiation, 0 for no launch bound; see
// kernels/_build.py::min_blocks).  One launch runs all `total` steps:
//   * MH move on every rung, every step (csrc/mh.cuh), int32 per-rung accept
//     counts after burn-in (post = step0 + s + 1 > burn_in);
//   * on post-burn-in multiples of swap_every, a swap sweep over the pairs
//     (j, j+1), log a = (beta_j - beta_{j+1})(lp_{j+1} - lp_j), each pair
//     seeing the state the pairs before it left, in the runtime pair order
//     `order`: 0 = j = 0..T-2 (the Pallas sweep), 1 = even pairs 0, 2, 4..
//     then odd pairs 1, 3, 5.. (the JAX scan engine's two half-sweeps
//     kernels/pt.py::_swap_phase, equal to this order because the pairs of
//     one parity are disjoint); pair j draws its uniform from rung j's
//     Philox slot d+1 in either order;
//   * int32 swap counts, Kahan-compensated sum of (dbeta)^2 over accepted
//     swaps and of the cold rung's squared jump (swap moves included).
//
// Layout.  One thread holds one (replica, slot).  A block is R replicas
// (threadIdx.x, so loads and stores of the (d, T, C) state are coalesced
// on the replica axis) x T slots (threadIdx.y).  The states live in a
// shared-memory slab, a row of DMAX + 4 words a thread, read and written
// four coordinates at a time with no bank conflicts (csrc/mh.cuh); a
// thread keeps only its proposal y[DMAX] in registers.  With the state in
// registers too, a thread took 116-125 registers at DMAX 32 and
// one 320-thread block filled an SM (10 of 64 warps), too few to hide
// Philox's chains of dependent integer multiplies; the slab halves the
// state's registers, and __launch_bounds__(kBlockThreads,
// RWM_PT_MINBLOCKS) holds the rest to what lets that many blocks share an
// SM.  Box-Muller's sines wait in a second slab (mh.cuh).  R = 32 (a
// compile-time constant) where 32 T threads fit the instantiation's
// maxThreadsPerBlock and the slabs fit a block's shared memory, else
// fewer, from an instantiation that reads R at run time (its runtime R
// takes registers of its own, so it is held to one block an SM and does
// not spill); the caller chooses R and the instantiation
// (kernels/_build.py::launch_geometry) and the launcher refuses what does
// not fit.  Nothing in the layout or the sweep is tied to a number of
// rungs: a ladder of more than 10 rungs (T up to the runtime-R
// instantiation's kBlockThreads, 320 or 256, or 256 in a build with no
// launch bound, whose thread ptxas gives at most 255 registers; fewer
// where the slabs fill a block's shared memory:
// kernels/_build.py::rungs_fit) runs R = floor(threads / T) replicas a
// block, and at T = 50 six.
// A swap does not move states between threads: it swaps the rung->slot map
// in shared memory, and each thread then reads its new rung (its beta,
// sigma and draw stream).  The states go to their rungs' places when the
// run ends.  A move's accept writes y into the slab only after the swap
// sweep, so the cold-rung jump across a pair-0 swap reads the old owner's
// pre-move state straight from the old owner's row.  Swap steps cost
// three __syncthreads; other steps none.
//
// Per-rung scales: s_sigma[t] is the Normal std sqrt(v c_t / beta_t) or the
// UniformRadius radius R sqrt(c_t) / sqrt(beta_t); Laplace reads a (T, d)
// table sqrt(v_i c_t / beta_t / 2) from shared memory, row = the thread's
// current rung.
//
// Recording is a runtime argument (a null `rec` means off): after the swap
// sweep of every launch-relative step that is a multiple of record_every,
// the thread that now owns rung 0 (the cold chain) of each of the first
// record_chains replicas writes its state to rec[k][i][c],
// k = step / every - 1 (n_rec = total / record_every; trailing steps run
// unrecorded).  Nothing limits the recorded batch on a card.  The Kahan
// sums run on unbroken while recording (the Pallas recording kernel
// restarts their compensation every segment, :196-199).
//
// Bound: operations.  Philox's integer work (60 int32 operations a block
// of four words, 6.29e11 at the flagship) outweighs the float work (one
// logf + one sqrtf + one sincosf a Box-Muller pair, Giles' polynomials,
// the target's terms) at the card's int32 and float32 rates; global memory
// sees the initial state and the final state + accumulators only.
// SuperFunnel (kind 12) is the exception: its likelihood (J n
// observations of 2K + 7 flops, an expf and a log1pf each) outweighs
// Philox, so its bound is the float32 or the special-function (MUFU) work
// (chip_smoke.py::sf_lp_flops, SF_MUFU_PER_OBS).  Its usual build fixes
// the dataset's shape (-DRWM_PT_SF_J, -DRWM_PT_SF_K, -DRWM_PT_SF_N, and
// -DRWM_PT_SF_UNROLL, the observation loop's unroll), as the TPU kernel
// fixes it at trace time: d is then a constant, the proposal's alphas and
// betas are registers at compile-time indices, and the dataset rides in
// the kernel's parameters (csrc/targets.cuh::SuperFunnelFixed; the
// launcher copies it from the host) instead of the shared-memory slabs;
// the run-time-shape build stages the proposal in a row for the
// datasets too large for the parameters.  The ragged edge (C not a
// multiple of R) is masked: those threads run on zeros in their own rows
// and store nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=p -DRWM_PT_NORMAL=n
//        -DRWM_PT_TARGET=k -DRWM_PT_DMAX=D -DRWM_PT_MINBLOCKS=b
//        [-DRWM_PT_SF_J=J -DRWM_PT_SF_K=K -DRWM_PT_SF_N=n
//         -DRWM_PT_SF_UNROLL=u]   (no --use_fast_math)
// Plain PyTorch version: fused_pt.py::_run_pt_fused_plain.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mh.cuh"

#ifndef RWM_PT_PROPOSAL
#define RWM_PT_PROPOSAL PROPOSAL_NORMAL
#endif
#ifndef RWM_PT_NORMAL
#define RWM_PT_NORMAL DRAW_ICDF
#endif
#ifndef RWM_PT_TARGET
#define RWM_PT_TARGET TARGET_ROSENBROCK
#endif
#ifndef RWM_PT_DMAX
#define RWM_PT_DMAX 32
#endif
#ifndef RWM_PT_MINBLOCKS
#define RWM_PT_MINBLOCKS 1
#endif
// SuperFunnel with the dataset's shape fixed at build time: the kernel
// takes the dataset as its last parameter
#ifdef RWM_PT_SF_N
using FixedData = SuperFunnelBuild;   // csrc/mh.cuh
constexpr int kFixedDim = FixedData::kDim;
#define RWM_PT_FIXED_PARAM , const __grid_constant__ FixedData fixed
#define RWM_PT_FIXED_ARG , fixed
#else
constexpr int kFixedDim = 0;   // none: the target's parameters in shared memory
#define RWM_PT_FIXED_PARAM
#define RWM_PT_FIXED_ARG
#endif

namespace {

constexpr int kMaxReplicas = 32;    // replicas per block (threadIdx.x)
// the launch bound: 32 replicas x 10 rungs, or in a fixed SuperFunnel
// shape's build 32 x 8, the rungs of its geometric ladder, so that blocks
// of T = 8 meet the register cap that kMinBlocks of them set (four of 320
// threads, 64 registers, spill; three of 256, 80 registers, do not)
constexpr int kBlockThreads = kFixedDim ? 256 : 320;
constexpr int kMaxSharedBytes = 227 * 1024;   // a block's dynamic shared memory

constexpr int kProp = RWM_PT_PROPOSAL;
constexpr int kDraw = RWM_PT_NORMAL;
constexpr int kKind = RWM_PT_TARGET;
constexpr int kDmax = RWM_PT_DMAX;   // the register bucket: d <= kDmax
constexpr int kMinBlocks = RWM_PT_MINBLOCKS;

constexpr int kPitch = kRowPitch<kDmax>;   // words of a thread's state row
constexpr int kSines = (kProp != PROPOSAL_LAPLACE && kDraw == DRAW_BM)
                           ? kSinePitch<kDmax> : 0;   // of its sine row
constexpr int kStageWords =
    kFixedDim ? 0 : kStage<kKind, kDmax>;   // of its stage row

// Words of dynamic shared memory: the state slab (T R rows of kPitch,
// first, so that its rows are 16-byte aligned) | Box-Muller sines (T R
// rows of kSines) | SuperFunnel's stage rows (T R rows of kStageWords) |
// params (none in a fixed-shape build), beta, sigma | lp, u (per slot /
// pair) | cold sum, compensation | slot_of_rung, rung_of_slot, accepts |
// the slot that held rung 0 before a sweep that moved it | Laplace scales
// (T, d).  kernels/_build.py::pt_shared_bytes mirrors this count.
__host__ __device__ constexpr size_t shared_words(int n_params, int T, int d,
                                                  int R) {
  return (size_t)T * R * (kPitch + kSines + kStageWords) +
         (kFixedDim ? 0 : n_params) + 2 * T +
         2 * T * R +
         2 * R + 3 * T * R + R + (kProp == PROPOSAL_LAPLACE ? T * d : 0);
}

// The launch bound of an instantiation: kMinBlocks blocks of kBlockThreads
// for the 32-replica one, one block for the runtime-R one; none at all
// for kMinBlocks 0 (a kernel that spills even under one block's cap: the
// compiler takes the registers it needs, and a block holds the threads
// they allow)
#if RWM_PT_MINBLOCKS > 0
#define RWM_PT_BOUNDS(rfix) __launch_bounds__(kBlockThreads, (rfix) ? kMinBlocks : 1)
#else
#define RWM_PT_BOUNDS(rfix)
#endif

template <int KIND, int DMAX, int RFIX>
__global__ void RWM_PT_BOUNDS(RFIX) fused_pt_kernel(
    const float* __restrict__ params, int n_params,
    const float* __restrict__ betas, const float* __restrict__ sigmas,
    const float* __restrict__ x0, const int* __restrict__ acc0,
    const int* __restrict__ swapacc0, const float* __restrict__ bj0,
    const float* __restrict__ cj0, float* __restrict__ x_out,
    float* __restrict__ lp_out, int* __restrict__ acc_out,
    int* __restrict__ swapacc_out, float* __restrict__ bj_out,
    float* __restrict__ cj_out, int d, int T, int C, int total, int burn_in,
    int swap_every, int step0, uint32_t key0, uint32_t key1, int replica0,
    int rung0, const float* __restrict__ lap, float inv_d,
    float* __restrict__ rec, int record_every, int record_chains,
    int order RWM_PT_FIXED_PARAM) {
  extern __shared__ float4 smem4[];
  if (kFixedDim) d = kFixedDim;   // a constant in a fixed-shape build
  // replicas per block: a compile-time 32 on the usual path (a runtime R
  // in the shared-memory indexing costs ~2 % of the flagship's time)
  const int R = RFIX ? RFIX : (int)blockDim.x;
  const int nthreads = R * T;
  float* s_x = (float*)smem4;         // [tid][i]
  float* s_sn = s_x + nthreads * kPitch;   // [tid][k], Box-Muller only
  float* s_stage = s_sn + nthreads * kSines;   // [tid][i], SuperFunnel
  float* s_params = s_stage + nthreads * kStageWords;
#ifdef RWM_PT_SF_N
  // the log-density's parameters: the kernel parameter's dataset
  const float* lp_params = reinterpret_cast<const float*>(&fixed);
#else
  const float* lp_params = s_params;
#endif
  float* s_beta = s_params + n_params;
  float* s_sigma = s_beta + T;
  float* s_lp = s_sigma + T;          // [slot][replica]
  float* s_u = s_lp + T * R;          // [pair][replica]
  float* s_cold = s_u + T * R;        // [replica]
  float* s_cc = s_cold + R;           // [replica]
  int* s_slot = (int*)(s_cc + R);     // [rung][replica] -> slot
  int* s_rung = s_slot + T * R;       // [slot][replica] -> rung
  int* s_acc = s_rung + T * R;        // [rung][replica]
  int* s_owner = s_acc + T * R;       // [replica]
  float* s_lap = (float*)(s_owner + R);   // [rung][i], Laplace only

  const int cx = threadIdx.x, slot = threadIdx.y;
  const int tid = slot * R + cx;
  const int c = blockIdx.x * R + cx;
  const bool valid = c < C;
  float* xs = s_x + tid * kPitch;     // this thread's state row
  float* stage = s_stage + tid * kStageWords;

  for (int i = tid; i < n_params; i += nthreads) s_params[i] = params[i];
  for (int i = tid; i < T; i += nthreads) {
    s_beta[i] = betas[i];
    s_sigma[i] = sigmas[i];
  }
  if (kProp == PROPOSAL_LAPLACE)
    for (int i = tid; i < T * d; i += nthreads) s_lap[i] = lap[i];
  s_slot[tid] = slot;
  s_rung[tid] = slot;
  s_acc[tid] = valid ? acc0[(size_t)slot * C + c] : 0;
  if (slot == 0) {
    s_cold[cx] = valid ? cj0[c] : 0.0f;
    s_cc[cx] = 0.0f;
  }

  float y[DMAX];   // the state, then each step's proposal
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    y[i] = (i < d && valid) ? x0[((size_t)i * T + slot) * C + c] : 0.0f;
  store_row<DMAX>(y, xs, d);
  __syncthreads();
  float lp = state_log_density<KIND, DMAX>(y, stage, d, lp_params);
  int rung = slot;
  // the sweep's per-replica sums live in the slot-0 thread, which runs it
  int swapacc = (slot == 0 && valid) ? swapacc0[c] : 0;
  float bj = (slot == 0 && valid) ? bj0[c] : 0.0f, bc = 0.0f;

  for (int s = 0; s < total; ++s) {
    const int abs_step = step0 + s + 1;
    const bool post = abs_step > burn_in;
    const bool do_swap = post && (abs_step % swap_every == 0);
    uint4 blk;
    int cur_k = -1;
    const bool accept = mh_propose<KIND, kProp, kDraw, DMAX>(
        y, xs, s_sn + tid * kSines, stage, lp, d, lp_params,
        s_sigma[rung], s_lap + rung * d, inv_d, s_beta[rung], c + replica0,
        rung + rung0, abs_step, key0, key1, blk, cur_k);
    if (post && accept) s_acc[rung * R + cx] += 1;

    int new_rung = rung, owner = -1;
    if (do_swap) {   // the same for every thread of the block
      s_lp[tid] = lp;
      if (rung < T - 1)
        s_u[rung * R + cx] = uniform_from_bits(slot_word(
            d + 1, blk, cur_k, c + replica0, rung + rung0, abs_step, key0,
            key1));
      __syncthreads();
      if (slot == 0) {
        const int first = s_slot[cx];   // rung 0's slot before the sweep
        int moved = 0;
        const int n_even = T >> 1;   // pairs 0, 2, .. of 0..T-2
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
      }
      __syncthreads();
      new_rung = s_rung[tid];
      owner = s_owner[cx];   // >= 0: rung 0 changed hands in this sweep
    } else if (slot == 0 && bc != 0.0f) {
      // the sweep's compensation step with no swap accepted (exactly what a
      // no-swap step does to the sums; a no-op while bc == 0)
      for (int j = 0; j < T - 1; ++j) {
        const float yk = 0.0f - bc;
        const float tot = bj + yk;
        bc = (tot - bj) - yk;
        bj = tot;
      }
    }
    rung = new_rung;
    if (rung == 0) {   // cold-rung squared jump, Kahan-summed
      float jump = 0.0f;
      if (owner >= 0) {
        // this thread took rung 0 in the sweep: its state after the move
        // against the old owner's state before it (the slab still holds
        // every pre-move state)
        if (!accept) load_row<DMAX>(y, xs, d);
        jump = sq_jump<DMAX>(y, s_x + (owner * R + cx) * kPitch, d);
      } else if (accept) {
        jump = sq_jump<DMAX>(y, xs, d);
      }
      const float yk = (post ? jump : 0.0f) - s_cc[cx];
      const float tot = s_cold[cx] + yk;
      s_cc[cx] = (tot - s_cold[cx]) - yk;
      s_cold[cx] = tot;
    }
    if (do_swap) __syncthreads();   // the pre-move states have been read
    if (accept) store_row<DMAX>(y, xs, d);
    if (rec != nullptr && rung == 0 && c < record_chains &&
        (s + 1) % record_every == 0) {   // the cold chain, after the sweep
      const size_t k = (size_t)((s + 1) / record_every - 1);
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) rec[(k * d + i) * record_chains + c] = xs[i];
    }
  }

  __syncthreads();
  if (valid) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) x_out[((size_t)i * T + rung) * C + c] = xs[i];
    lp_out[(size_t)rung * C + c] = lp;
    acc_out[(size_t)slot * C + c] = s_acc[tid];
    if (slot == 0) {
      swapacc_out[c] = swapacc;
      bj_out[c] = bj;
      cj_out[c] = s_cold[cx];
    }
  }
}

using Kernel = decltype(&fused_pt_kernel<kKind, kDmax, 0>);

// The instantiation for R replicas a block: compile-time 32, else runtime.
Kernel kernel_for(int runtime_r) {
  return runtime_r ? fused_pt_kernel<kKind, kDmax, 0>
                   : fused_pt_kernel<kKind, kDmax, kMaxReplicas>;
}

// Every launch needs more than the default 48 KB of dynamic shared memory
// at the flagship, and the most shared memory an SM can give (228 KB) so
// that several blocks share it.
cudaError_t prepare(Kernel kernel, size_t shmem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Attributes of the instantiation a launch of R replicas x T rungs at d
// coordinates takes (runtime_r: the runtime-R one): out = {registers,
// maxThreadsPerBlock, local bytes a thread, dynamic shared bytes, blocks
// per SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor}.
extern "C" int rwm_pt_fused_pt_info(int runtime_r, int d, int T, int R,
                                    int n_params, int* out) {
  if (d < 1 || T < 1 || R < 1 || n_params < 0)
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(runtime_r);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t shmem = shared_words(n_params, T, d, R) * sizeof(float);
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shmem;
  out[4] = 0;
  if (shmem > kMaxSharedBytes || R * T > attr.maxThreadsPerBlock) return 0;
  e = prepare(kernel, shmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], kernel, R * T, shmem);
}

extern "C" int rwm_pt_fused_pt(
    int kind, const float* params, int n_params, const float* betas,
    const float* sigmas, const float* x0, const int* acc0,
    const int* swapacc0, const float* bj0, const float* cj0, float* x_out,
    float* lp_out, int* acc_out, int* swapacc_out, float* bj_out,
    float* cj_out, int d, int T, int C, int total, int burn_in,
    int swap_every, int step0, uint32_t key0, uint32_t key1, int replica0,
    int rung0, const float* lap, float inv_d, float* rec, int record_every,
    int record_chains, int order, int R, int runtime_r, void* stream) {
  if (d < 1 || d > kDmax || T < 1 || C < 1 || total < 0 ||
      swap_every < 1 || kind != kKind || (order != 0 && order != 1) ||
      (kFixedDim && d != kFixedDim) ||
      R < 1 || R > kMaxReplicas || (!runtime_r && R != kMaxReplicas) ||
      (kProp == PROPOSAL_LAPLACE && lap == nullptr) ||
      (rec != nullptr && (record_every < 1 || record_chains < 1 ||
                          record_chains > C)))
    return (int)cudaErrorInvalidValue;
  // R replicas a block in the instantiation the caller chose; refused if
  // R x T threads exceed its maxThreadsPerBlock or the slabs a block's
  // shared memory
  const Kernel kernel = kernel_for(runtime_r);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  if (R * T > attr.maxThreadsPerBlock)
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = shared_words(n_params, T, d, R) * sizeof(float);
  if (shmem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  e = prepare(kernel, shmem);
  if (e != cudaSuccess) return (int)e;
#ifdef RWM_PT_SF_N
  // a fixed-shape build: params is the host's packed dataset
  // (kernels/_build.py::sf_pack), copied into the kernel's last parameter
  if (params == nullptr || n_params * sizeof(float) != sizeof(FixedData))
    return (int)cudaErrorInvalidValue;
  FixedData fixed;
  memcpy(&fixed, params, sizeof(FixedData));
  params = nullptr;
  n_params = 0;
#endif
  const dim3 grid((C + R - 1) / R);
  const dim3 block(R, T);
  kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      params, n_params, betas, sigmas, x0, acc0, swapacc0, bj0, cj0, x_out,
      lp_out, acc_out, swapacc_out, bj_out, cj_out, d, T, C, total, burn_in,
      swap_every, step0, key0, key1, replica0, rung0, lap, inv_d, rec,
      record_every, record_chains, order RWM_PT_FIXED_ARG);
  return (int)cudaGetLastError();
}
