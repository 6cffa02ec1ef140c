// Fused whole-run Parallel Tempering kernel for Hopper (sm_90a).
//
// Replaces rwm_pt_tpu/kernels/pallas_pt.py::_make_kernel (:107-148) and
// _make_record_kernel (:151-222) with their body _pt_body_fn (:41-96), the
// Pallas kernels behind run_pt_pallas (ICDF draw), with the Normal, Laplace
// and UniformRadius increments (csrc/mh.cuh; per-rung scales as
// pallas_pt.py:307-320).  One library is built per proposal
// (-DRWM_PT_PROPOSAL=0/1/2) from this one source.  One launch runs all
// `total` steps:
//   * MH move on every rung, every step (csrc/mh.cuh), int32 per-rung accept
//     counts after burn-in (post = step0 + s + 1 > burn_in);
//   * on post-burn-in multiples of swap_every, the exact sequential swap
//     sweep j = 0..T-2, log a = (beta_j - beta_{j+1})(lp_{j+1} - lp_j), each
//     pair seeing the state the pairs before it left;
//   * int32 swap counts, Kahan-compensated sum of (dbeta)^2 over accepted
//     swaps and of the cold rung's squared jump (swap moves included).
//
// Layout.  A replica's ladder is T*d floats (300 at the flagship d=30,
// T=10), above a thread's 255 registers, so one thread holds one
// (replica, slot): its d coordinates in registers, 2*DMAX floats live with
// the proposal.  A block is 32 replicas (threadIdx.x, so loads and stores of
// the (d, T, C) state are coalesced on the replica axis) x T slots
// (threadIdx.y).  A swap does not move states between threads: it swaps the
// rung->slot map in shared memory, and each thread then reads its new rung
// (its beta, sigma and draw stream).  The states go to their rungs' places
// when the run ends.  The cold-rung jump across a pair-0 swap needs the old
// owner's pre-move state: that one case goes through shared memory.
// Swap steps cost three __syncthreads; other steps none.
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
// Bound: operations (Philox integer rounds, one logf + one sqrtf per normal,
// Giles' polynomials, the target's terms); global memory sees the initial
// state and the final state + accumulators only.  The ragged edge (C not a
// multiple of 32) is masked: those threads run on zeros and store nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DRWM_PT_PROPOSAL=k (no --use_fast_math)
// Plain PyTorch version: fused_pt.py::_run_pt_fused_plain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mh.cuh"

#ifndef RWM_PT_PROPOSAL
#define RWM_PT_PROPOSAL PROPOSAL_NORMAL
#endif

namespace {

constexpr int kReplicas = 32;   // replicas per block (threadIdx.x)

constexpr int kProp = RWM_PT_PROPOSAL;

template <int DMAX>
__host__ __device__ constexpr size_t shared_words(int n_params, int T, int d) {
  // params, beta, sigma | lp, u (per slot / pair) | old cold state | cold sum,
  // compensation | slot_of_rung, rung_of_slot, accepts | pair-0 flag |
  // Laplace scales (T, d)
  return (size_t)n_params + 2 * T + 2 * T * kReplicas + DMAX * kReplicas +
         2 * kReplicas + 3 * T * kReplicas + kReplicas +
         (kProp == PROPOSAL_LAPLACE ? T * d : 0);
}

template <int KIND, int DMAX>
__global__ void fused_pt_kernel(
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
    int record_every, int record_chains) {
  extern __shared__ float smem[];
  float* s_params = smem;
  float* s_beta = s_params + n_params;
  float* s_sigma = s_beta + T;
  float* s_lp = s_sigma + T;                  // [slot][replica]
  float* s_u = s_lp + T * kReplicas;          // [pair][replica]
  float* s_old = s_u + T * kReplicas;         // [i][replica]
  float* s_cold = s_old + DMAX * kReplicas;   // [replica]
  float* s_cc = s_cold + kReplicas;           // [replica]
  int* s_slot = (int*)(s_cc + kReplicas);     // [rung][replica] -> slot
  int* s_rung = s_slot + T * kReplicas;       // [slot][replica] -> rung
  int* s_acc = s_rung + T * kReplicas;        // [rung][replica]
  int* s_flag = s_acc + T * kReplicas;        // [replica]
  float* s_lap = (float*)(s_flag + kReplicas);  // [rung][i], Laplace only

  const int cx = threadIdx.x, slot = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = slot * kReplicas + cx;
  const int c = blockIdx.x * kReplicas + cx;
  const bool valid = c < C;

  for (int i = tid; i < n_params; i += nthreads) s_params[i] = params[i];
  for (int i = tid; i < T; i += nthreads) {
    s_beta[i] = betas[i];
    s_sigma[i] = sigmas[i];
  }
  if (kProp == PROPOSAL_LAPLACE)
    for (int i = tid; i < T * d; i += nthreads) s_lap[i] = lap[i];
  s_slot[slot * kReplicas + cx] = slot;
  s_rung[slot * kReplicas + cx] = slot;
  s_acc[slot * kReplicas + cx] = valid ? acc0[(size_t)slot * C + c] : 0;
  if (slot == 0) {
    s_cold[cx] = valid ? cj0[c] : 0.0f;
    s_cc[cx] = 0.0f;
  }

  float x[DMAX], p[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    x[i] = (i < d && valid) ? x0[((size_t)i * T + slot) * C + c] : 0.0f;
  __syncthreads();
  float lp = log_density<KIND, DMAX>(x, d, s_params);
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
    float jump;
    const bool accept = mh_move<KIND, kProp, DMAX>(
        x, p, lp, jump, d, s_params, s_sigma[rung], s_lap + rung * d, inv_d,
        s_beta[rung], c, rung, abs_step, key0, key1, blk, cur_k);
    if (post && accept) s_acc[rung * kReplicas + cx] += 1;

    int new_rung = rung;
    if (do_swap) {   // the same for every thread of the block
      s_lp[slot * kReplicas + cx] = lp;
      if (rung < T - 1)
        s_u[rung * kReplicas + cx] = uniform_from_bits(slot_word(
            d + 1, blk, cur_k, c, rung, abs_step, key0, key1));
      __syncthreads();
      if (slot == 0) {
        int flag = 0;
        for (int j = 0; j < T - 1; ++j) {
          const int a = s_slot[j * kReplicas + cx];
          const int b = s_slot[(j + 1) * kReplicas + cx];
          const float db = s_beta[j] - s_beta[j + 1];
          const float log_swap =
              db * (s_lp[b * kReplicas + cx] - s_lp[a * kReplicas + cx]);
          const bool sw = s_u[j * kReplicas + cx] < expf(log_swap);
          if (sw) {
            s_slot[j * kReplicas + cx] = b;
            s_slot[(j + 1) * kReplicas + cx] = a;
            swapacc += 1;
            if (j == 0) flag = 1;
          }
          const float y = (sw ? __fmul_rn(db, db) : 0.0f) - bc;
          const float tot = bj + y;
          bc = (tot - bj) - y;
          bj = tot;
        }
        for (int j = 0; j < T; ++j)
          s_rung[s_slot[j * kReplicas + cx] * kReplicas + cx] = j;
        s_flag[cx] = flag;
      }
      __syncthreads();
      new_rung = s_rung[slot * kReplicas + cx];
      const bool moved = s_flag[cx] != 0;   // rung 0 changed hands
      if (moved && rung == 0) {
#pragma unroll
        for (int i = 0; i < DMAX; ++i)
          if (i < d) s_old[i * kReplicas + cx] = p[i];
      }
      __syncthreads();
      if (moved && new_rung == 0) {
        jump = 0.0f;
#pragma unroll
        for (int i = 0; i < DMAX; ++i) {
          if (i < d) {
            const float dd = x[i] - s_old[i * kReplicas + cx];
            jump += dd * dd;
          }
        }
      }
    } else if (slot == 0 && bc != 0.0f) {
      // the sweep's compensation step with no swap accepted (exactly what a
      // no-swap step does to the sums; a no-op while bc == 0)
      for (int j = 0; j < T - 1; ++j) {
        const float y = 0.0f - bc;
        const float tot = bj + y;
        bc = (tot - bj) - y;
        bj = tot;
      }
    }
    rung = new_rung;
    if (rung == 0) {   // cold-rung squared jump, Kahan-summed
      const float y = (post ? jump : 0.0f) - s_cc[cx];
      const float tot = s_cold[cx] + y;
      s_cc[cx] = (tot - s_cold[cx]) - y;
      s_cold[cx] = tot;
    }
    if (rec != nullptr && rung == 0 && c < record_chains &&
        (s + 1) % record_every == 0) {   // the cold chain, after the sweep
      const size_t k = (size_t)((s + 1) / record_every - 1);
#pragma unroll
      for (int i = 0; i < DMAX; ++i)
        if (i < d) rec[(k * d + i) * record_chains + c] = x[i];
    }
  }

  __syncthreads();
  if (valid) {
#pragma unroll
    for (int i = 0; i < DMAX; ++i)
      if (i < d) x_out[((size_t)i * T + rung) * C + c] = x[i];
    lp_out[(size_t)rung * C + c] = lp;
    acc_out[(size_t)slot * C + c] = s_acc[slot * kReplicas + cx];
    if (slot == 0) {
      swapacc_out[c] = swapacc;
      bj_out[c] = bj;
      cj_out[c] = s_cold[cx];
    }
  }
}

template <int KIND, int DMAX>
int launch_pt(const float* params, int n_params, const float* betas,
              const float* sigmas, const float* x0, const int* acc0,
              const int* swapacc0, const float* bj0, const float* cj0,
              float* x_out, float* lp_out, int* acc_out, int* swapacc_out,
              float* bj_out, float* cj_out, int d, int T, int C, int total,
              int burn_in, int swap_every, int step0, uint32_t key0,
              uint32_t key1, const float* lap, float inv_d, float* rec,
              int record_every, int record_chains, cudaStream_t stream) {
  const size_t shmem = shared_words<DMAX>(n_params, T, d) * sizeof(float);
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + kReplicas - 1) / kReplicas);
  const dim3 block(kReplicas, T);
  fused_pt_kernel<KIND, DMAX><<<grid, block, shmem, stream>>>(
      params, n_params, betas, sigmas, x0, acc0, swapacc0, bj0, cj0, x_out,
      lp_out, acc_out, swapacc_out, bj_out, cj_out, d, T, C, total, burn_in,
      swap_every, step0, key0, key1, lap, inv_d, rec, record_every,
      record_chains);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rwm_pt_fused_pt(
    int kind, const float* params, int n_params, const float* betas,
    const float* sigmas, const float* x0, const int* acc0,
    const int* swapacc0, const float* bj0, const float* cj0, float* x_out,
    float* lp_out, int* acc_out, int* swapacc_out, float* bj_out,
    float* cj_out, int d, int T, int C, int total, int burn_in,
    int swap_every, int step0, uint32_t key0, uint32_t key1,
    const float* lap, float inv_d, float* rec, int record_every,
    int record_chains, void* stream) {
  if (d < 1 || d > 64 || T < 1 || T > 32 || C < 1 || total < 0 ||
      swap_every < 1 ||
      (kind != TARGET_ROSENBROCK && kind != TARGET_MVN_ISO) ||
      (kProp == PROPOSAL_LAPLACE && lap == nullptr) ||
      (rec != nullptr && (record_every < 1 || record_chains < 1 ||
                          record_chains > C)))
    return (int)cudaErrorInvalidValue;
  RWM_PT_DISPATCH(kind, d, launch_pt, params, n_params, betas, sigmas, x0,
                  acc0, swapacc0, bj0, cj0, x_out, lp_out, acc_out,
                  swapacc_out, bj_out, cj_out, d, T, C, total, burn_in,
                  swap_every, step0, key0, key1, lap, inv_d, rec,
                  record_every, record_chains, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;  // unreachable: every branch returns
}
