// Fused whole-run Random Walk Metropolis kernel for Hopper (sm_90a).
//
// Replaces rwm_pt_tpu/kernels/pallas_rwm.py::_make_kernel (:259-321) and
// _make_record_kernel (:324-414), the Pallas kernels behind run_rwm_pallas
// with the Normal, Laplace and UniformRadius increments and the ICDF,
// Box-Muller or draw-study normal draw (csrc/mh.cuh).  One library is built
// per (proposal, draw, target kind, register bucket DMAX = 8, 16, 32 or 64)
// from this one source (-DRWM_PT_PROPOSAL, -DRWM_PT_NORMAL,
// -DRWM_PT_TARGET, -DRWM_PT_DMAX, -DRWM_PT_MINBLOCKS).
// One thread per chain runs all `total` steps: Philox draws, proposal,
// log-density, accept, an int32 accept count after burn-in and a
// Kahan-summed squared-jump (ESJD) sum.  The chain's state lives in a
// shared-memory slab, a row of DMAX + 4 words a thread read four
// coordinates at a time with no bank conflicts (csrc/mh.cuh), and only the
// proposal y[DMAX] in registers, so a thread takes
// about half the registers a state in registers cost and more warps share
// an SM; __launch_bounds__(kThreads, RWM_PT_MINBLOCKS) caps the registers
// to fit that many blocks (kernels/_build.py::min_blocks).  Box-Muller's
// sines wait in a second slab (csrc/mh.cuh).  Global memory sees the
// initial state and the final state + accumulators only, so the kernel is
// bound by operations: Philox's integer work (60 int32 operations a block
// of four words, 6.29e10 at the 65,536-chain headline) outweighs the float
// work (one logf and one sqrtf per normal, Giles' polynomials, log1pf per
// Laplace coordinate, the target's terms) at the card's rates, but for
// SuperFunnel, whose likelihood's float and special-function work binds
// (csrc/fused_pt.cu; as there, its usual build fixes the dataset's shape
// and takes the dataset as a kernel parameter).
// Consecutive threads take consecutive chains, so every load and store of
// the (d, C) state is coalesced on the chain axis.  The ragged edge (C not
// a multiple of the block) is masked.
//
// Recording is a runtime argument (a null `rec` means off): after every
// launch-relative step that is a multiple of record_every, the first
// record_chains chains write their state to rec[k][i][c], k = step / every - 1
// (n_rec = total / record_every entries; trailing steps run unrecorded).  On
// a card nothing limits the recorded batch: unlike the TPU kernel there is
// no single-block requirement.  The jump sum stays Kahan-compensated while
// recording (the Pallas recording kernel sums it plainly, :382).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=p -DRWM_PT_NORMAL=n
//        -DRWM_PT_TARGET=k -DRWM_PT_DMAX=D -DRWM_PT_MINBLOCKS=b
//        [-DRWM_PT_SF_J=J -DRWM_PT_SF_K=K -DRWM_PT_SF_N=n
//         -DRWM_PT_SF_UNROLL=u]   (no --use_fast_math)
// Plain PyTorch version: fused_rwm.py::_run_rwm_fused_plain.
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
// SuperFunnel with the dataset's shape fixed at build time (fused_pt.cu)
#ifdef RWM_PT_SF_N
using FixedData = SuperFunnelBuild;   // csrc/mh.cuh
constexpr int kFixedDim = FixedData::kDim;
#define RWM_PT_FIXED_PARAM , const __grid_constant__ FixedData fixed
#define RWM_PT_FIXED_ARG , fixed
#else
constexpr int kFixedDim = 0;
#define RWM_PT_FIXED_PARAM
#define RWM_PT_FIXED_ARG
#endif

namespace {

constexpr int kThreads = 128;       // chains a block, the launch bound
constexpr int kMaxSharedBytes = 227 * 1024;   // a block's dynamic shared memory
constexpr int kProp = RWM_PT_PROPOSAL;
constexpr int kDraw = RWM_PT_NORMAL;
constexpr int kKind = RWM_PT_TARGET;
constexpr int kDmax = RWM_PT_DMAX;   // the register bucket: d <= kDmax
constexpr int kMinBlocks = RWM_PT_MINBLOCKS;
constexpr int kPitch = kRowPitch<kDmax>;   // words of a chain's state row
constexpr int kSines = (kProp != PROPOSAL_LAPLACE && kDraw == DRAW_BM)
                           ? kSinePitch<kDmax> : 0;   // of its sine row
constexpr int kStageWords =
    kFixedDim ? 0 : kStage<kKind, kDmax>;   // of its stage row

// Words of dynamic shared memory: the state slab (threads rows of kPitch,
// first, 16-byte aligned) | Box-Muller sines (threads rows of kSines) |
// SuperFunnel's stage rows (threads rows of kStageWords) | params (none
// in a fixed-shape build) | Laplace scales (d).
// kernels/_build.py::rwm_shared_bytes mirrors this count.
__host__ __device__ constexpr size_t shared_words(int n_params, int d,
                                                  int threads) {
  return (size_t)threads * (kPitch + kSines + kStageWords) +
         (kFixedDim ? 0 : n_params) + (kProp == PROPOSAL_LAPLACE ? d : 0);
}

// The launch bound: kMinBlocks blocks of kThreads; none for kMinBlocks 0
#if RWM_PT_MINBLOCKS > 0
#define RWM_PT_BOUNDS __launch_bounds__(kThreads, kMinBlocks)
#else
#define RWM_PT_BOUNDS
#endif

template <int KIND, int DMAX>
__global__ void RWM_PT_BOUNDS
    fused_rwm_kernel(const float* __restrict__ params, int n_params,
                     float scale, float beta, const float* __restrict__ x0,
                     const int* __restrict__ acc0,
                     const float* __restrict__ jump0,
                     float* __restrict__ x_out, float* __restrict__ lp_out,
                     int* __restrict__ acc_out, float* __restrict__ jump_out,
                     int d, int C, int total, int burn_in, int step0,
                     uint32_t key0, uint32_t key1, int replica0,
                     const float* __restrict__ lap, float inv_d,
                     float* __restrict__ rec, int record_every,
                     int record_chains RWM_PT_FIXED_PARAM) {
  extern __shared__ float4 smem4[];
  if (kFixedDim) d = kFixedDim;   // a constant in a fixed-shape build
  float* s_x = (float*)smem4;           // [thread][i]
  float* s_sn = s_x + blockDim.x * kPitch;   // [thread][k], Box-Muller only
  float* s_stage = s_sn + blockDim.x * kSines;   // [thread][i], SuperFunnel
  float* s_params = s_stage + blockDim.x * kStageWords;
  float* s_lap = s_params + n_params;   // (d,) Laplace scales
#ifdef RWM_PT_SF_N
  // the log-density's parameters: the kernel parameter's dataset
  const float* lp_params = reinterpret_cast<const float*>(&fixed);
#else
  const float* lp_params = s_params;
#endif
  for (int i = threadIdx.x; i < n_params; i += blockDim.x)
    s_params[i] = params[i];
  if (kProp == PROPOSAL_LAPLACE)
    for (int i = threadIdx.x; i < d; i += blockDim.x) s_lap[i] = lap[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float* xs = s_x + threadIdx.x * kPitch;   // this chain's state row
  float* stage = s_stage + threadIdx.x * kStageWords;

  float y[DMAX];   // the state, then each step's proposal
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    y[i] = i < d ? x0[(size_t)i * C + c] : 0.0f;
  store_row<DMAX>(y, xs, d);
  float lp = state_log_density<KIND, DMAX>(y, stage, d, lp_params);
  int acc = acc0[c];
  float esjd = jump0[c], comp = 0.0f;   // Kahan sum and its compensation

  for (int s = 0; s < total; ++s) {
    const int abs_step = step0 + s + 1;
    const bool post = abs_step > burn_in;
    uint4 blk;
    int cur_k = -1;
    const bool accept = mh_propose<KIND, kProp, kDraw, DMAX>(
        y, xs, s_sn + threadIdx.x * kSines, stage, lp, d, lp_params, scale,
        s_lap, inv_d, beta, c + replica0, 0, abs_step, key0, key1, blk,
        cur_k);
    acc += (post && accept) ? 1 : 0;
    float jump = 0.0f;
    if (accept) {
      jump = sq_jump<DMAX>(y, xs, d);
      store_row<DMAX>(y, xs, d);
    }
    const float yk = (post ? jump : 0.0f) - comp;
    const float tot = esjd + yk;
    comp = (tot - esjd) - yk;
    esjd = tot;
    if (rec != nullptr && c < record_chains && (s + 1) % record_every == 0) {
      const size_t k = (size_t)((s + 1) / record_every - 1);
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) rec[(k * d + i) * record_chains + c] = xs[i];
    }
  }

#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < d) x_out[(size_t)i * C + c] = xs[i];
  lp_out[c] = lp;
  acc_out[c] = acc;
  jump_out[c] = esjd;
}

using Kernel = decltype(&fused_rwm_kernel<kKind, kDmax>);

// the library's one instantiation
Kernel kernel() { return fused_rwm_kernel<kKind, kDmax>; }

// Dynamic shared memory above the default 48 KB where a launch needs it,
// and the most shared memory an SM can give (228 KB) so that many blocks
// share it.
cudaError_t prepare(size_t shmem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel(),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Attributes of the kernel and of a launch of `threads` chains a block at
// d coordinates: out = {registers, maxThreadsPerBlock, local bytes a
// thread, dynamic shared bytes, blocks per SM by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor}.
extern "C" int rwm_pt_fused_rwm_info(int d, int threads, int n_params,
                                     int* out) {
  if (d < 1 || threads < 1 || n_params < 0)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel());
  if (e != cudaSuccess) return (int)e;
  const size_t shmem = shared_words(n_params, d, threads) * sizeof(float);
  out[0] = attr.numRegs;
  out[1] = attr.maxThreadsPerBlock;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shmem;
  out[4] = 0;
  if (shmem > kMaxSharedBytes || threads > attr.maxThreadsPerBlock) return 0;
  e = prepare(shmem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[4], kernel(), threads, shmem);
}

extern "C" int rwm_pt_fused_rwm(int kind, const float* params, int n_params,
                                float scale, float beta, const float* x0,
                                const int* acc0, const float* jump0,
                                float* x_out, float* lp_out, int* acc_out,
                                float* jump_out, int d, int C, int total,
                                int burn_in, int step0, uint32_t key0,
                                uint32_t key1, int replica0,
                                const float* lap, float inv_d,
                                float* rec, int record_every,
                                int record_chains, int threads,
                                void* stream) {
  if (d < 1 || d > kDmax || C < 1 || total < 0 || kind != kKind ||
      (kFixedDim && d != kFixedDim) ||
      threads < 1 || threads > kThreads ||
      (kProp == PROPOSAL_LAPLACE && lap == nullptr) ||
      (rec != nullptr && (record_every < 1 || record_chains < 1 ||
                          record_chains > C)))
    return (int)cudaErrorInvalidValue;
  // `threads` chains a block, as the caller chose them; refused if the
  // slabs exceed a block's shared memory
  const size_t shmem = shared_words(n_params, d, threads) * sizeof(float);
  if (shmem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const cudaError_t e = prepare(shmem);
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
  const Kernel k = kernel();
  k<<<(C + threads - 1) / threads, threads, shmem, (cudaStream_t)stream>>>(
      params, n_params, scale, beta, x0, acc0, jump0, x_out, lp_out, acc_out,
      jump_out, d, C, total, burn_in, step0, key0, key1, replica0, lap,
      inv_d, rec, record_every, record_chains RWM_PT_FIXED_ARG);
  return (int)cudaGetLastError();
}
