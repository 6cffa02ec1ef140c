// Philox4x32-10 (Salmon et al., SC'11), counter-based: the same words as
// rwm_pt_tpu_torch/kernels/draws.py::philox4x32, whose docstring defines the
// counter/slot layout the kernels follow:
//   key = (seed lo, seed hi), counter = (block k, replica, rung, abs_step),
//   slot j = 4k + w: 0..d-1 increment words, d MH uniform, d+1 swap
//   uniform, d+2 UniformRadius radius uniform.
// The replica and rung are those of the whole run: a launch that runs one
// shard of it (kernels/fused_sharded.py) adds its first replica and rung,
// the kernels' replica0 and rung0 (the RWM kernels take replica0 alone:
// they draw at rung 0), so it draws what the unsharded launch draws for
// those rows.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ uint32_t philox_word(uint4 b, int w) {
  return w == 0 ? b.x : (w == 1 ? b.y : (w == 2 ? b.z : b.w));
}

// Block k of the (replica, rung, abs_step) stream.
__device__ __forceinline__ uint4 philox_block(int k, int replica, int rung,
                                              int abs_step, uint32_t key0,
                                              uint32_t key1) {
  return philox4x32_10(make_uint4((uint32_t)k, (uint32_t)replica,
                                  (uint32_t)rung, (uint32_t)abs_step),
                       key0, key1);
}

// Word of slot j, reusing the block in `blk` when it is block j/4 already.
__device__ __forceinline__ uint32_t slot_word(int j, uint4& blk, int& cur_k,
                                              int replica, int rung,
                                              int abs_step, uint32_t key0,
                                              uint32_t key1) {
  const int k = j >> 2;
  if (k != cur_k) {
    blk = philox_block(k, replica, rung, abs_step, key0, key1);
    cur_k = k;
  }
  return philox_word(blk, j & 3);
}
