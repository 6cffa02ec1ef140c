// Fused whole-run Random Walk Metropolis kernel for Hopper (sm_90a), one
// warp a chain: the d > 64 configuration of
// rwm_pt_tpu/kernels/pallas_rwm.py::_make_kernel (:259-321) and
// _make_record_kernel (:324-414), which run at any d (the Pallas kernel
// only shrinks its VMEM block as d grows, :225-234).  csrc/fused_rwm.cu
// keeps d <= 64 at one thread a chain; above that a thread's proposal
// y[DMAX] no longer fits its registers and one thread would compute
// ceil((d + 1) / 4) Philox blocks in series each step.  Here a warp holds
// a chain and lane l computes Philox block l (and l + 32) of the step
// (csrc/warp.cuh), so the step's blocks, the increments and the
// log-density's terms run side by side, and sums are butterflies whose
// result every lane holds alike.
//
// One library per (proposal, draw, target kind, warp bucket DMAX = 128 or
// 256 slots, d + 4 <= DMAX) from this source (-DRWM_PT_PROPOSAL,
// -DRWM_PT_NORMAL, -DRWM_PT_TARGET, -DRWM_PT_DMAX); every proposal and
// normal draw of csrc/fused_rwm.cu, int32 accepts after burn-in, the
// Kahan-summed squared jump, the runtime `rec` trace.  A block holds
// `chains` warps (kernels/_build.py::rwm_warp_geometry: at most 8, fewer
// where a small C would leave SMs idle); each warp's state row and scratch
// row (DMAX words each) live in shared memory, with the parameters (when
// they take at most kParamsShared words; the full-covariance MVN's d x d
// precision above d ~ 110 is read through L2 instead) and Laplace's (d,)
// scales.  Bound: operations, Philox's int32 work as at d <= 64; global
// memory sees the initial and the final state only (a lane's loads stride
// C words, once a run).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=p -DRWM_PT_NORMAL=n
//        -DRWM_PT_TARGET=k -DRWM_PT_DMAX=D (no --use_fast_math)
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

namespace {

constexpr int kThreads = 256;       // the launch bound: 8 chains a block
constexpr int kMaxSharedBytes = 227 * 1024;   // a block's dynamic shared memory
constexpr int kParamsShared = 12288;          // params in shared memory up to
constexpr int kProp = RWM_PT_PROPOSAL;
constexpr int kDraw = RWM_PT_NORMAL;
constexpr int kKind = RWM_PT_TARGET;
constexpr int kDmax = RWM_PT_DMAX;   // the warp bucket: d + 4 <= kDmax
constexpr int kNQ = kDmax / 128;     // register quads a lane
static_assert(kDmax % 128 == 0, "warp buckets are multiples of 128 slots");

__host__ __device__ constexpr int params_in_shared(int n_params) {
  return n_params <= kParamsShared ? n_params : 0;
}

// Words of dynamic shared memory: state rows (chains x kDmax, first, so
// 16-byte aligned) | scratch rows (chains x kDmax) | params (when they
// fit) | Laplace scales (d).  kernels/_build.py::rwm_warp_shared_bytes
// mirrors this count.
__host__ __device__ constexpr size_t shared_words(int n_params, int d,
                                                  int chains) {
  return (size_t)chains * 2 * kDmax + params_in_shared(n_params) +
         (kProp == PROPOSAL_LAPLACE ? d : 0);
}

template <int KIND, int NQ>
__global__ void __launch_bounds__(kThreads)
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
                          uint32_t key1, const float* __restrict__ lap,
                          float inv_d, float* __restrict__ rec,
                          int record_every, int record_chains) {
  extern __shared__ float4 smem4[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_x = (float*)smem4;              // [warp][i]
  float* s_row = s_x + nw * kDmax;         // [warp][i], scratch
  float* s_params = s_row + nw * kDmax;
  const int n_shared = params_in_shared(n_params);
  float* s_lap = s_params + n_shared;      // (d,) Laplace scales
  for (int i = threadIdx.x; i < n_shared; i += blockDim.x)
    s_params[i] = params[i];
  if (kProp == PROPOSAL_LAPLACE)
    for (int i = threadIdx.x; i < d; i += blockDim.x) s_lap[i] = lap[i];
  __syncthreads();
  const int c = blockIdx.x * nw + warp;
  if (c >= C) return;   // the whole warp
  const float* p = n_shared ? s_params : params;
  float* xs = s_x + warp * kDmax;          // this chain's state row
  float* row = s_row + warp * kDmax;

  float4 y[NQ];   // the lane's coordinates of the state, then the proposal
#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = own_index(k, lane, w);
      set_word(y[k], w, i < d ? x0[(size_t)i * C + c] : 0.0f);
    }
  warp_store<NQ>(y, xs, d, lane);
  float lp = warp_log_density<KIND, NQ>(y, row, d, p, lane);
  int acc = acc0[c];
  float esjd = jump0[c], comp = 0.0f;   // Kahan sum and its compensation

  for (int s = 0; s < total; ++s) {
    const int abs_step = step0 + s + 1;
    const bool post = abs_step > burn_in;
    float u_swap;
    const bool accept = warp_mh_propose<KIND, kProp, kDraw, NQ>(
        y, xs, row, lp, d, p, scale, s_lap, inv_d, beta, lane, c, 0,
        abs_step, key0, key1, u_swap);
    acc += (post && accept) ? 1 : 0;
    float jump = 0.0f;
    if (accept) {   // the same in every lane
      jump = warp_sq_jump<NQ>(y, xs, d, lane);
      warp_store<NQ>(y, xs, d, lane);
    }
    const float yk = (post ? jump : 0.0f) - comp;
    const float tot = esjd + yk;
    comp = (tot - esjd) - yk;
    esjd = tot;
    if (rec != nullptr && c < record_chains && (s + 1) % record_every == 0) {
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

#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = own_index(k, lane, w);
      if (i < d) x_out[(size_t)i * C + c] = xs[i];
    }
  if (lane == 0) {
    lp_out[c] = lp;
    acc_out[c] = acc;
    jump_out[c] = esjd;
  }
}

using Kernel = decltype(&fused_rwm_warp_kernel<kKind, kNQ>);

// the library's one instantiation
Kernel kernel() { return fused_rwm_warp_kernel<kKind, kNQ>; }

cudaError_t prepare(size_t shmem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel(),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Attributes of the kernel and of a launch of `chains` warps a block at d
// coordinates: out = {registers, maxThreadsPerBlock, local bytes a
// thread, dynamic shared bytes, blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor}.  The same C interface
// as csrc/fused_rwm.cu's, with chains (warps) a block for threads.
extern "C" int rwm_pt_fused_rwm_info(int d, int chains, int n_params,
                                     int* out) {
  if (d < 1 || chains < 1 || n_params < 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel());
  if (e != cudaSuccess) return (int)e;
  const size_t shmem = shared_words(n_params, d, chains) * sizeof(float);
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shmem;
  out[4] = 0;
  if (shmem > kMaxSharedBytes || 32 * chains > attr.maxThreadsPerBlock)
    return 0;
  e = prepare(shmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], kernel(), 32 * chains, shmem);
}

extern "C" int rwm_pt_fused_rwm(int kind, const float* params, int n_params,
                                float scale, float beta, const float* x0,
                                const int* acc0, const float* jump0,
                                float* x_out, float* lp_out, int* acc_out,
                                float* jump_out, int d, int C, int total,
                                int burn_in, int step0, uint32_t key0,
                                uint32_t key1, const float* lap, float inv_d,
                                float* rec, int record_every,
                                int record_chains, int chains,
                                void* stream) {
  if (d < 1 || d + 4 > kDmax || C < 1 || total < 0 || kind != kKind ||
      chains < 1 || 32 * chains > kThreads ||
      (kProp == PROPOSAL_LAPLACE && lap == nullptr) ||
      (rec != nullptr && (record_every < 1 || record_chains < 1 ||
                          record_chains > C)))
    return (int)cudaErrorInvalidValue;
  const size_t shmem = shared_words(n_params, d, chains) * sizeof(float);
  if (shmem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare(shmem);
  if (e != cudaSuccess) return (int)e;
  const Kernel k = kernel();
  k<<<(C + chains - 1) / chains, 32 * chains, shmem,
      (cudaStream_t)stream>>>(
      params, n_params, scale, beta, x0, acc0, jump0, x_out, lp_out, acc_out,
      jump_out, d, C, total, burn_in, step0, key0, key1, lap, inv_d, rec,
      record_every, record_chains);
  return (int)cudaGetLastError();
}
