// Fused whole-run Random Walk Metropolis kernel for Hopper (sm_90a).
//
// Replaces rwm_pt_tpu/kernels/pallas_rwm.py::_make_kernel (:259-321) and
// _make_record_kernel (:324-414), the Pallas kernels behind run_rwm_pallas
// with the Normal, Laplace and UniformRadius increments and the ICDF or
// Box-Muller normal draw (csrc/mh.cuh).  One library is built per
// (proposal, draw, target kind, register bucket DMAX = 8, 16, 32 or 64)
// from this one source (-DRWM_PT_PROPOSAL, -DRWM_PT_NORMAL,
// -DRWM_PT_TARGET, -DRWM_PT_DMAX).
// One thread per chain holds the chain's d coordinates in registers and runs
// all `total` steps: Philox draws, proposal, log-density, accept, an int32
// accept count after burn-in and a Kahan-summed squared-jump (ESJD) sum.
// Global memory sees the initial state and the final state + accumulators
// only, so the kernel is bound by operations (Philox integer rounds, one logf
// and one sqrtf per normal, Giles' polynomials, log1pf per Laplace
// coordinate, the target's terms), not by bytes.  Consecutive threads take
// consecutive chains, so every load and store of the (d, C) state is
// coalesced on the chain axis.  The ragged edge (C not a multiple of the
// block) is masked.
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
//        -DRWM_PT_TARGET=k -DRWM_PT_DMAX=D (no --use_fast_math)
// Plain PyTorch version: fused_rwm.py::_run_rwm_fused_plain.
#include <cuda_runtime.h>
#include <stdint.h>

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

namespace {

constexpr int kThreads = 128;
constexpr int kProp = RWM_PT_PROPOSAL;
constexpr int kDraw = RWM_PT_NORMAL;
constexpr int kKind = RWM_PT_TARGET;
constexpr int kDmax = RWM_PT_DMAX;   // the register bucket: d <= kDmax

template <int KIND, int DMAX>
__global__ void __launch_bounds__(kThreads)
    fused_rwm_kernel(const float* __restrict__ params, int n_params,
                     float scale, float beta, const float* __restrict__ x0,
                     const int* __restrict__ acc0,
                     const float* __restrict__ jump0,
                     float* __restrict__ x_out, float* __restrict__ lp_out,
                     int* __restrict__ acc_out, float* __restrict__ jump_out,
                     int d, int C, int total, int burn_in, int step0,
                     uint32_t key0, uint32_t key1,
                     const float* __restrict__ lap, float inv_d,
                     float* __restrict__ rec, int record_every,
                     int record_chains) {
  extern __shared__ float s_params[];
  float* s_lap = s_params + n_params;   // (d,) Laplace scales
  for (int i = threadIdx.x; i < n_params; i += blockDim.x)
    s_params[i] = params[i];
  if (kProp == PROPOSAL_LAPLACE)
    for (int i = threadIdx.x; i < d; i += blockDim.x) s_lap[i] = lap[i];
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;

  float x[DMAX], p[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    x[i] = i < d ? x0[(size_t)i * C + c] : 0.0f;
  float lp = log_density<KIND, DMAX>(x, d, s_params);
  int acc = acc0[c];
  float esjd = jump0[c], comp = 0.0f;   // Kahan sum and its compensation

  for (int s = 0; s < total; ++s) {
    const int abs_step = step0 + s + 1;
    const bool post = abs_step > burn_in;
    uint4 blk;
    int cur_k = -1;
    float jump;
    const bool accept = mh_move<KIND, kProp, kDraw, DMAX>(
        x, p, lp, jump, d, s_params, scale, s_lap, inv_d, beta, c, 0,
        abs_step, key0, key1, blk, cur_k);
    acc += (post && accept) ? 1 : 0;
    const float y = (post ? jump : 0.0f) - comp;
    const float tot = esjd + y;
    comp = (tot - esjd) - y;
    esjd = tot;
    if (rec != nullptr && c < record_chains && (s + 1) % record_every == 0) {
      const size_t k = (size_t)((s + 1) / record_every - 1);
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) rec[(k * d + i) * record_chains + c] = x[i];
    }
  }

#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < d) x_out[(size_t)i * C + c] = x[i];
  lp_out[c] = lp;
  acc_out[c] = acc;
  jump_out[c] = esjd;
}

template <int KIND, int DMAX>
int launch_rwm(const float* params, int n_params, float scale, float beta,
               const float* x0, const int* acc0, const float* jump0,
               float* x_out, float* lp_out, int* acc_out, float* jump_out,
               int d, int C, int total, int burn_in, int step0, uint32_t key0,
               uint32_t key1, const float* lap, float inv_d, float* rec,
               int record_every, int record_chains, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads);
  const size_t shmem =
      (n_params + (kProp == PROPOSAL_LAPLACE ? d : 0)) * sizeof(float);
  if (shmem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_rwm_kernel<KIND, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_rwm_kernel<KIND, DMAX><<<grid, kThreads, shmem, stream>>>(
      params, n_params, scale, beta, x0, acc0, jump0, x_out, lp_out, acc_out,
      jump_out, d, C, total, burn_in, step0, key0, key1, lap, inv_d, rec,
      record_every, record_chains);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwm_pt_fused_rwm(int kind, const float* params, int n_params,
                                float scale, float beta, const float* x0,
                                const int* acc0, const float* jump0,
                                float* x_out, float* lp_out, int* acc_out,
                                float* jump_out, int d, int C, int total,
                                int burn_in, int step0, uint32_t key0,
                                uint32_t key1, const float* lap, float inv_d,
                                float* rec, int record_every,
                                int record_chains, void* stream) {
  if (d < 1 || d > kDmax || C < 1 || total < 0 || kind != kKind ||
      (kProp == PROPOSAL_LAPLACE && lap == nullptr) ||
      (rec != nullptr && (record_every < 1 || record_chains < 1 ||
                          record_chains > C)))
    return (int)cudaErrorInvalidValue;
  return launch_rwm<kKind, kDmax>(
      params, n_params, scale, beta, x0, acc0, jump0, x_out, lp_out, acc_out,
      jump_out, d, C, total, burn_in, step0, key0, key1, lap, inv_d, rec,
      record_every, record_chains, (cudaStream_t)stream);
}
