// Fused whole-run Parallel Tempering kernel for Hopper (sm_90a), one warp
// a (replica, rung): the d > 64 configuration of
// rwm_pt_tpu/kernels/pallas_pt.py::_make_kernel (:107-148) and
// _make_record_kernel (:151-222) with their body _pt_body_fn (:41-96),
// which run at any d (the Pallas kernel only shrinks its VMEM block as d
// grows, :31-38).  csrc/fused_pt.cu keeps d <= 64 at one thread a
// (replica, rung); above that a thread's proposal no longer fits its
// registers and one thread would compute ceil((d + 2) / 4) Philox blocks
// in series each step.  Here each lane computes its own block(s) of the
// step and the coordinates' terms, sums are butterflies every lane holds
// alike (csrc/warp.cuh), so the warp's 32 lanes move or stay together.
//
// One library per (proposal, draw, target kind, warp bucket DMAX = 128 or
// 256 slots, d + 4 <= DMAX) from this source.  Everything of
// csrc/fused_pt.cu carries over at the warp level: MH on every rung every
// step with int32 per-rung accepts after burn-in; on post-burn-in
// multiples of swap_every the sweep over the pairs (j, j+1) in the
// runtime order `order` (0: j = 0..T-2, the Pallas sweep; 1: even pairs
// then odd pairs, the scan engine's two half-sweeps), pair j's uniform
// from rung j's slot d+1, run by lane 0 of the slot-0 warp of each
// replica between two __syncthreads; "move" semantics (a swap changes the
// rung->slot map in shared memory, and the states reach their rungs'
// places when the run ends); an accept's store deferred past the sweep so
// the cold-rung jump across a pair-0 swap reads the old owner's pre-move
// row; Kahan sums of (dbeta)^2 over accepted swaps and of the cold rung's
// squared jump; per-rung scales s_sigma[t] (Normal std, UniformRadius
// radius) and Laplace's (T, d) table, so the autotune handoff's per-rung
// multipliers land here as on the thread kernel; the runtime `rec` trace
// of the cold chain.
//
// Layout.  A block is R replicas x T rung-warps, threadIdx = (lane,
// replica, slot), R T <= 32 warps (kernels/_build.py::pt_warp_geometry
// chooses R; the launcher refuses what does not fit).  Each warp's state
// row and scratch row (DMAX words each) live in shared memory with the
// parameters (when at most kParamsShared words; else read through L2),
// the ladder and the sweep's words.  __launch_bounds__(32 kMaxWarps): 32
// warps a block at T = 32 in the 128 bucket, so at most 64 registers a
// thread; 16 warps, at most 128 registers, in the 256 bucket.
// Bound: operations, Philox's int32 work as at d <= 64.  The ragged edge
// (C not a multiple of R) is masked: those warps run on zeros in their
// own rows and store nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=p -DRWM_PT_NORMAL=n
//        -DRWM_PT_TARGET=k -DRWM_PT_DMAX=D (no --use_fast_math)
// Plain PyTorch version: fused_pt.py::_run_pt_fused_plain.
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

namespace {

// R x T warps a block, the launch bound's: 32 (T up to 32) in the 128
// bucket, whose kernels fit 64 registers; 16 in the 256 bucket, whose
// second register quad a lane and the sweep's bookkeeping need more (at
// 64 and at 80 registers they spill), so T <= 16 there
// (kernels/_build.py::max_rungs)
constexpr int kMaxWarps = RWM_PT_DMAX > 128 ? 16 : 32;
constexpr int kBlockThreads = 32 * kMaxWarps;
constexpr int kMaxSharedBytes = 227 * 1024;     // a block's dynamic shared memory
constexpr int kParamsShared = 12288;            // params in shared memory up to
constexpr int kProp = RWM_PT_PROPOSAL;
constexpr int kDraw = RWM_PT_NORMAL;
constexpr int kKind = RWM_PT_TARGET;
constexpr int kDmax = RWM_PT_DMAX;   // the warp bucket: d + 4 <= kDmax
constexpr int kNQ = kDmax / 128;     // register quads a lane
static_assert(kDmax % 128 == 0, "warp buckets are multiples of 128 slots");

__host__ __device__ constexpr int params_in_shared(int n_params) {
  return n_params <= kParamsShared ? n_params : 0;
}

// Words of dynamic shared memory: state rows (T R x kDmax, first, so
// 16-byte aligned) | scratch rows (T R x kDmax) | params (when they fit)
// | beta, sigma | lp, u (per slot / pair) | cold sum, compensation, the
// sweep's beta-jump sum, its compensation, its swap count (per replica:
// kept in shared memory, not in the sweeping lane's registers) |
// slot_of_rung, rung_of_slot, accepts | the slot that held rung 0 before a
// sweep that moved it | Laplace scales (T, d).
// kernels/_build.py::pt_warp_shared_bytes mirrors this count.
__host__ __device__ constexpr size_t shared_words(int n_params, int T, int d,
                                                  int R) {
  return (size_t)T * R * 2 * kDmax + params_in_shared(n_params) + 2 * T +
         2 * T * R + 5 * R + 3 * T * R + R +
         (kProp == PROPOSAL_LAPLACE ? T * d : 0);
}

template <int KIND, int NQ>
__global__ void __launch_bounds__(kBlockThreads) fused_pt_warp_kernel(
    const float* __restrict__ params, int n_params,
    const float* __restrict__ betas, const float* __restrict__ sigmas,
    const float* __restrict__ x0, const int* __restrict__ acc0,
    const int* __restrict__ swapacc0, const float* __restrict__ bj0,
    const float* __restrict__ cj0, float* __restrict__ x_out,
    float* __restrict__ lp_out, int* __restrict__ acc_out,
    int* __restrict__ swapacc_out, float* __restrict__ bj_out,
    float* __restrict__ cj_out, int d, int T, int C, int total, int burn_in,
    int swap_every, int step0, uint32_t key0, uint32_t key1,
    const float* __restrict__ lap, float inv_d, float* __restrict__ rec,
    int record_every, int record_chains, int order) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x, cx = threadIdx.y, slot = threadIdx.z;
  const int R = blockDim.y;
  const int nwarps = R * T;
  const int tid = slot * R + cx;          // the warp
  const int flat = tid * 32 + lane;       // the thread, for block-wide loads
  const int nthreads = nwarps * 32;
  const int n_shared = params_in_shared(n_params);
  float* s_x = (float*)smem4;             // [warp][i]
  float* s_row = s_x + nwarps * kDmax;    // [warp][i], scratch
  float* s_params = s_row + nwarps * kDmax;
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
  int* s_acc = s_rung + T * R;            // [rung][replica]
  int* s_owner = s_acc + T * R;           // [replica]
  float* s_lap = (float*)(s_owner + R);   // [rung][i], Laplace only

  const int c = blockIdx.x * R + cx;
  const bool valid = c < C;
  float* xs = s_x + tid * kDmax;          // this warp's state row
  float* row = s_row + tid * kDmax;

  for (int i = flat; i < n_shared; i += nthreads) s_params[i] = params[i];
  for (int i = flat; i < T; i += nthreads) {
    s_beta[i] = betas[i];
    s_sigma[i] = sigmas[i];
  }
  if (kProp == PROPOSAL_LAPLACE)
    for (int i = flat; i < T * d; i += nthreads) s_lap[i] = lap[i];
  if (lane == 0) {
    s_slot[tid] = slot;
    s_rung[tid] = slot;
    s_acc[tid] = valid ? acc0[(size_t)slot * C + c] : 0;
    if (slot == 0) {
      s_cold[cx] = valid ? cj0[c] : 0.0f;
      s_cc[cx] = 0.0f;
      s_bj[cx] = valid ? bj0[c] : 0.0f;
      s_bc[cx] = 0.0f;
      s_swapacc[cx] = valid ? swapacc0[c] : 0;
    }
  }

  float4 y[NQ];   // the lane's coordinates of the state, then the proposal
#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = own_index(k, lane, w);
      set_word(y[k], w, (i < d && valid)
                            ? x0[((size_t)i * T + slot) * C + c] : 0.0f);
    }
  warp_store<NQ>(y, xs, d, lane);
  __syncthreads();
  const float* p = n_shared ? s_params : params;
  float lp = warp_log_density<KIND, NQ>(y, row, d, p, lane);
  int rung = slot;
  // lane 0 of the slot-0 warp runs the sweep of its replica
  const bool sweeper = slot == 0 && lane == 0;

  for (int s = 0; s < total; ++s) {
    const int abs_step = step0 + s + 1;
    const bool post = abs_step > burn_in;
    const bool do_swap = post && (abs_step % swap_every == 0);
    float u_swap;
    const bool accept = warp_mh_propose<KIND, kProp, kDraw, NQ>(
        y, xs, row, lp, d, p, s_sigma[rung], s_lap + rung * d, inv_d,
        s_beta[rung], lane, c, rung, abs_step, key0, key1, u_swap);
    if (lane == 0 && post && accept) s_acc[rung * R + cx] += 1;

    int new_rung = rung, owner = -1;
    if (do_swap) {   // the same for every warp of the block
      if (lane == 0) {
        s_lp[tid] = lp;
        if (rung < T - 1) s_u[rung * R + cx] = u_swap;
      }
      __syncthreads();
      if (sweeper) {
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
      __syncthreads();
      new_rung = s_rung[tid];
      owner = s_owner[cx];   // >= 0: rung 0 changed hands in this sweep
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
    if (rung == 0) {   // cold-rung squared jump, Kahan-summed
      float jump = 0.0f;
      if (owner >= 0) {
        // this warp took rung 0 in the sweep: its state after the move
        // against the old owner's state before it
        if (!accept) warp_load<NQ>(y, xs, d, lane);
        jump = warp_sq_jump<NQ>(y, s_x + (owner * R + cx) * kDmax, d, lane);
      } else if (accept) {
        jump = warp_sq_jump<NQ>(y, xs, d, lane);
      }
      if (lane == 0) {
        const float yk = (post ? jump : 0.0f) - s_cc[cx];
        const float tot = s_cold[cx] + yk;
        s_cc[cx] = (tot - s_cold[cx]) - yk;
        s_cold[cx] = tot;
      }
    }
    if (do_swap) __syncthreads();   // the pre-move states have been read
    if (accept) warp_store<NQ>(y, xs, d, lane);
    if (rec != nullptr && rung == 0 && c < record_chains &&
        (s + 1) % record_every == 0) {   // the cold chain, after the sweep
      const size_t k = (size_t)((s + 1) / record_every - 1);
#pragma unroll
      for (int kq = 0; kq < NQ; ++kq)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int i = own_index(kq, lane, w);
          if (i < d) rec[(k * d + i) * record_chains + c] = xs[i];
        }
    }
  }

  __syncthreads();
  if (valid) {
#pragma unroll
    for (int k = 0; k < NQ; ++k)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int i = own_index(k, lane, w);
        if (i < d) x_out[((size_t)i * T + rung) * C + c] = xs[i];
      }
    if (lane == 0) {
      lp_out[(size_t)rung * C + c] = lp;
      acc_out[(size_t)slot * C + c] = s_acc[tid];
      if (slot == 0) {
        swapacc_out[c] = s_swapacc[cx];
        bj_out[c] = s_bj[cx];
        cj_out[c] = s_cold[cx];
      }
    }
  }
}

using Kernel = decltype(&fused_pt_warp_kernel<kKind, kNQ>);

// the library's one instantiation
Kernel kernel() { return fused_pt_warp_kernel<kKind, kNQ>; }

cudaError_t prepare(size_t shmem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel(),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Attributes of a launch of R replicas x T rung-warps at d coordinates:
// out = {registers, maxThreadsPerBlock, local bytes a thread, dynamic
// shared bytes, blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor}.  The same C interface
// as csrc/fused_pt.cu's; `runtime_r` is accepted and ignored (one
// instantiation, R read at run time).
extern "C" int rwm_pt_fused_pt_info(int runtime_r, int d, int T, int R,
                                    int n_params, int* out) {
  (void)runtime_r;
  if (d < 1 || T < 1 || R < 1 || n_params < 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel());
  if (e != cudaSuccess) return (int)e;
  const size_t shmem = shared_words(n_params, T, d, R) * sizeof(float);
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shmem;
  out[4] = 0;
  if (shmem > kMaxSharedBytes || 32 * R * T > attr.maxThreadsPerBlock)
    return 0;
  e = prepare(shmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], kernel(), 32 * R * T, shmem);
}

extern "C" int rwm_pt_fused_pt(
    int kind, const float* params, int n_params, const float* betas,
    const float* sigmas, const float* x0, const int* acc0,
    const int* swapacc0, const float* bj0, const float* cj0, float* x_out,
    float* lp_out, int* acc_out, int* swapacc_out, float* bj_out,
    float* cj_out, int d, int T, int C, int total, int burn_in,
    int swap_every, int step0, uint32_t key0, uint32_t key1,
    const float* lap, float inv_d, float* rec, int record_every,
    int record_chains, int order, int R, int runtime_r, void* stream) {
  (void)runtime_r;
  if (d < 1 || d + 4 > kDmax || T < 1 || T > kMaxWarps || C < 1 ||
      total < 0 || swap_every < 1 || kind != kKind ||
      (order != 0 && order != 1) || R < 1 || R * T > kMaxWarps ||
      (kProp == PROPOSAL_LAPLACE && lap == nullptr) ||
      (rec != nullptr && (record_every < 1 || record_chains < 1 ||
                          record_chains > C)))
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel());
  if (e != cudaSuccess) return (int)e;
  if (32 * R * T > attr.maxThreadsPerBlock)
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = shared_words(n_params, T, d, R) * sizeof(float);
  if (shmem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  e = prepare(shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + R - 1) / R);
  const dim3 block(32, R, T);
  kernel()<<<grid, block, shmem, (cudaStream_t)stream>>>(
      params, n_params, betas, sigmas, x0, acc0, swapacc0, bj0, cj0, x_out,
      lp_out, acc_out, swapacc_out, bj_out, cj_out, d, T, C, total, burn_in,
      swap_every, step0, key0, key1, lap, inv_d, rec, record_every,
      record_chains, order);
  return (int)cudaGetLastError();
}
