// Fused whole-run Random Walk Metropolis kernel for Hopper (sm_90a).
//
// Replaces rwm_pt_tpu/kernels/pallas_rwm.py::_make_kernel (:259-321), the
// Pallas kernel behind run_rwm_pallas (Normal proposal, ICDF draw).
// One thread per chain holds the chain's d coordinates in registers and runs
// all `total` steps: Philox draws, proposal, log-density, accept, an int32
// accept count after burn-in and a Kahan-summed squared-jump (ESJD) sum.
// Global memory sees the initial state and the final state + accumulators
// only, so the kernel is bound by operations (Philox integer rounds, one logf
// and one sqrtf per normal, Giles' polynomials, the target's terms), not by
// bytes.  Consecutive threads take consecutive chains, so every load and
// store of the (d, C) state is coalesced on the chain axis.  The ragged edge
// (C not a multiple of the block) is masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v   (no --use_fast_math)
// Plain PyTorch version: fused_rwm.py::_run_rwm_fused_plain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mh.cuh"

namespace {

constexpr int kThreads = 128;

template <int KIND, int DMAX>
__global__ void __launch_bounds__(kThreads)
    fused_rwm_kernel(const float* __restrict__ params, int n_params,
                     float sigma, float beta, const float* __restrict__ x0,
                     const int* __restrict__ acc0,
                     const float* __restrict__ jump0,
                     float* __restrict__ x_out, float* __restrict__ lp_out,
                     int* __restrict__ acc_out, float* __restrict__ jump_out,
                     int d, int C, int total, int burn_in, int step0,
                     uint32_t key0, uint32_t key1) {
  extern __shared__ float s_params[];
  for (int i = threadIdx.x; i < n_params; i += blockDim.x)
    s_params[i] = params[i];
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
    const bool accept = mh_move<KIND, DMAX>(x, p, lp, jump, d, s_params, sigma,
                                            beta, c, 0, abs_step, key0, key1,
                                            blk, cur_k);
    acc += (post && accept) ? 1 : 0;
    const float y = (post ? jump : 0.0f) - comp;
    const float tot = esjd + y;
    comp = (tot - esjd) - y;
    esjd = tot;
  }

#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < d) x_out[(size_t)i * C + c] = x[i];
  lp_out[c] = lp;
  acc_out[c] = acc;
  jump_out[c] = esjd;
}

template <int KIND, int DMAX>
int launch_rwm(const float* params, int n_params, float sigma, float beta,
               const float* x0, const int* acc0, const float* jump0,
               float* x_out, float* lp_out, int* acc_out, float* jump_out,
               int d, int C, int total, int burn_in, int step0, uint32_t key0,
               uint32_t key1, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads);
  fused_rwm_kernel<KIND, DMAX><<<grid, kThreads, n_params * sizeof(float),
                                 stream>>>(
      params, n_params, sigma, beta, x0, acc0, jump0, x_out, lp_out, acc_out,
      jump_out, d, C, total, burn_in, step0, key0, key1);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwm_pt_fused_rwm(int kind, const float* params, int n_params,
                                float sigma, float beta, const float* x0,
                                const int* acc0, const float* jump0,
                                float* x_out, float* lp_out, int* acc_out,
                                float* jump_out, int d, int C, int total,
                                int burn_in, int step0, uint32_t key0,
                                uint32_t key1, void* stream) {
  if (d < 1 || d > 64 || C < 1 || total < 0 ||
      (kind != TARGET_ROSENBROCK && kind != TARGET_MVN_ISO))
    return (int)cudaErrorInvalidValue;
  RWM_PT_DISPATCH(kind, d, launch_rwm, params, n_params, sigma, beta, x0, acc0,
                  jump0, x_out, lp_out, acc_out, jump_out, d, C, total,
                  burn_in, step0, key0, key1, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;  // unreachable: every branch returns
}
