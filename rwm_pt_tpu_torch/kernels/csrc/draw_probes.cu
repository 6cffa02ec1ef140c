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
//     fused kernels run.
//   * fast_log replaces :459-468, the _fast_log probe (pl.pallas_call
//     :462): draws.cuh's fast_log of n floats.
// Bytes bound both on this card by the counted work (chip_smoke.py::bound),
// but draw_normals runs into its instruction issue first: two Philox blocks
// (20 rounds) and eight library-math normals (logf, sqrtf, sincosf or
// erfinvf, Giles' two polynomials) a column of 32 bytes.  So:
//   * draw_normals: one column a thread at 32 registers, so an SM holds 64
//     warps to hide the math's latency, and a grid of one thread a column;
//     a warp's stores to a row are 128 contiguous bytes already.  Measured
//     and not kept (PERF.md, section 6): four adjacent columns a thread
//     with one float4 store a row (48-64 registers, half the warps: slower
//     at 2^20 and 2^24 normals), and a grid capped at SMs x resident blocks
//     with a grid-stride loop (slower for four of the five draws at 2^24).
//     Box-Muller's sines wait in a shared row of kSinePitch<8> words a
//     thread.
//   * fast_log: 16-byte loads through the read-only path (__ldg), two in
//     flight a thread (four measured slower), and 16-byte stores; a scalar
//     head runs up to y's first 16-byte boundary (a view such as y[1:]) and
//     a scalar tail takes n % 4.  Where out is off by another amount than
//     y, the body stores scalars.  A grid of at most SMs x resident blocks
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor, taken once a
//     process) with a grid-stride loop.
//   * both: launched on the caller's stream, nothing allocated,
//     cudaGetLastError() returned.
// The draw is a runtime argument (impl: the -DRWM_PT_NORMAL code),
// dispatched to one instantiation each.  Plain PyTorch versions:
// kernels/draw_probes.py.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v (no --use_fast_math)
#include <cuda_runtime.h>
#include <stdint.h>

#include "mh.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // coordinates of a column: d = 8

// One column a thread: column j's two Philox blocks and eight normals,
// stored down its rows (a warp's stores to a row are 128 contiguous bytes).
template <int DRAW>
__global__ void __launch_bounds__(kThreads)
    draw_normals_kernel(uint32_t key0, uint32_t key1, int cols,
                        float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
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

// fast_log of quad q's four floats v into o[4q .. 4q + 3]
__device__ __forceinline__ void store_logs(float* o, long long q, float4 v,
                                           bool vec) {
  const float4 r = make_float4(fast_log(v.x), fast_log(v.y), fast_log(v.z),
                               fast_log(v.w));
  if (vec) {
    reinterpret_cast<float4*>(o)[q] = r;
  } else {
    o[4 * q] = r.x;
    o[4 * q + 1] = r.y;
    o[4 * q + 2] = r.z;
    o[4 * q + 3] = r.w;
  }
}

// head: floats before y's first 16-byte boundary (at most 3, at most n);
// vec_out: out + head is 16-byte aligned too
__global__ void __launch_bounds__(kThreads)
    fast_log_kernel(const float* __restrict__ y, float* __restrict__ out,
                    long long n, int head, bool vec_out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (t < head) out[t] = fast_log(__ldg(y + t));
  const long long nq = (n - head) >> 2;
  const float4* yq = reinterpret_cast<const float4*>(y + head);
  float* o = out + head;
  for (long long q = t; q < nq; q += 2 * stride) {
    const long long q2 = q + stride;   // a second load in flight
    const float4 v = __ldg(yq + q);
    const float4 v2 = q2 < nq ? __ldg(yq + q2) : v;
    store_logs(o, q, v, vec_out);
    if (q2 < nq) store_logs(o, q2, v2, vec_out);
  }
  const long long tail = head + 4 * nq;
  if (t < n - tail) out[tail + t] = fast_log(__ldg(y + tail + t));
}

// SMs x the blocks of `kernel` an SM holds at once, into `cap` on the first
// call (a static of the caller); the grid never exceeds it.
template <typename Kernel>
cudaError_t grid_cap(Kernel kernel, int& cap) {
  if (cap > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e == cudaSuccess && sms * per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess) cap = sms * per_sm;
  return e;
}

// blocks for `work` items, one a thread: at least 1, at most cap
int blocks_for(long long work, int cap) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b < cap ? b : cap));
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

extern "C" int rwm_pt_fast_log(const float* y, float* out, long long n,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  static int cap = 0;
  const cudaError_t e = grid_cap(fast_log_kernel, cap);
  if (e != cudaSuccess) return (int)e;
  long long head = ((16 - ((uintptr_t)y & 15)) & 15) / 4;
  if (head > n) head = n;
  const bool vec_out = ((uintptr_t)(out + head) & 15) == 0;
  fast_log_kernel<<<blocks_for((n - head) >> 2, cap), kThreads, 0,
                    (cudaStream_t)stream>>>(y, out, n, (int)head, vec_out);
  return (int)cudaGetLastError();
}
