// Probe kernels of the normal-draw study for Hopper (sm_90a).
//
// Replace the JAX package's two test probe kernels:
//   * draw_normals replaces tests/test_pallas_kernels.py:399-412, the
//     normal-draw probe `draw(impl)` (pl.pallas_call :403): an (8, cols)
//     block of normals of one draw.  Column j is replica j at rung 0 and
//     absolute step 1 of the Philox stream, row k coordinate k of
//     kernels/draws.py's slot layout for d = 8: the draws of the ICDF slot
//     layout read slot k, Box-Muller pairs rows k and k + 4 (u1 from slot k,
//     u2 from slot 4 + k).  The normals are mh.cuh's and draws.cuh's own
//     (bm_normals, icdf_layout_normal), so the probe checks the code the
//     fused kernels run.  One thread a column: two Philox blocks, eight
//     stores, each coalesced on the column axis.
//   * fast_log replaces :459-468, the _fast_log probe (pl.pallas_call
//     :462): draws.cuh's fast_log of n floats, one thread each.
// Both are elementwise, so the bytes they store (and fast_log's loads) bound
// them on this card, not operations.  The draw is a runtime argument here
// (impl: the -DRWM_PT_NORMAL code), dispatched to one instantiation each.
// Plain PyTorch versions: kernels/draw_probes.py.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v (no --use_fast_math)
#include <cuda_runtime.h>
#include <stdint.h>

#include "mh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // coordinates of a column: d = 8

template <int DRAW>
__global__ void __launch_bounds__(kThreads)
    draw_normals_kernel(uint32_t key0, uint32_t key1, int cols,
                        float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float p[kRows];
  uint4 blk;
  int cur_k = -1;
  if constexpr (DRAW == DRAW_BM) {
    __shared__ float s_sn[kThreads * kSinePitch<kRows>];   // the sines' rows
    bm_normals<kRows>(p, s_sn + threadIdx.x * kSinePitch<kRows>, kRows, j, 0,
                      1, key0, key1, blk, cur_k);
  } else {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      p[i] = icdf_layout_normal<DRAW>(uniform_from_bits(
          slot_word(i, blk, cur_k, j, 0, 1, key0, key1)));
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) out[(size_t)i * cols + j] = p[i];
}

__global__ void __launch_bounds__(kThreads)
    fast_log_kernel(const float* __restrict__ y, float* __restrict__ out,
                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = fast_log(y[i]);
}

template <int DRAW>
int launch_normals(uint32_t key0, uint32_t key1, int cols, float* out,
                   cudaStream_t stream) {
  draw_normals_kernel<DRAW><<<(cols + kThreads - 1) / kThreads, kThreads, 0,
                              stream>>>(key0, key1, cols, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwm_pt_draw_normals(int impl, uint32_t key0, uint32_t key1,
                                   int cols, float* out, void* stream) {
  if (cols < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (impl) {
    case DRAW_ICDF:
      return launch_normals<DRAW_ICDF>(key0, key1, cols, out, s);
    case DRAW_BM:
      return launch_normals<DRAW_BM>(key0, key1, cols, out, s);
    case DRAW_ICDF_FASTLOG:
      return launch_normals<DRAW_ICDF_FASTLOG>(key0, key1, cols, out, s);
    case DRAW_LAX_ERFINV:
      return launch_normals<DRAW_LAX_ERFINV>(key0, key1, cols, out, s);
    case DRAW_FAKE_UNIFORM:
      return launch_normals<DRAW_FAKE_UNIFORM>(key0, key1, cols, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int rwm_pt_fast_log(const float* y, float* out, int n,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  fast_log_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    (cudaStream_t)stream>>>(y, out, n);
  return (int)cudaGetLastError();
}
