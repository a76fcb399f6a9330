// Dropout bits for the attention kernels: Philox-4x32-10 (Salmon et al.,
// "Parallel random numbers: as easy as 1, 2, 3", SC 2011), keyed by the
// 64-bit seed, with the counter (key / 4, query, head, batch).  One call
// gives the bits of four consecutive keys of one (batch, head, query), so the
// mask is a pure function of (seed, b, h, q, k): the backward regenerates it
// and no [B, H, Tq, Tk] mask reaches memory.  A key is kept when its 32-bit
// word is >= threshold = uint32(rate * 2^32), the threshold rule of the TPU
// kernel's `_mask_from_bits`.
//
// few_shot_transformer_tts_torch/ops/mha.py `dropout_keep_mask` computes the
// same bits in plain PyTorch; the two must change together.

#pragma once

#include <cuda_runtime.h>

namespace philox {

constexpr unsigned kM0 = 0xD2511F53u;
constexpr unsigned kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u;
constexpr unsigned kW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      key.x += kW0;
      key.y += kW1;
    }
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
  }
  return c;
}

// The words of keys 4*kgroup .. 4*kgroup+3 for query q of head h, batch b.
__device__ __forceinline__ uint4 dropout_bits(unsigned long long seed,
                                              int kgroup, int q, int h,
                                              int b) {
  return philox4x32_10(
      make_uint4(static_cast<unsigned>(kgroup), static_cast<unsigned>(q),
                 static_cast<unsigned>(h), static_cast<unsigned>(b)),
      make_uint2(static_cast<unsigned>(seed),
                 static_cast<unsigned>(seed >> 32)));
}

__device__ __forceinline__ unsigned word(uint4 w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

}  // namespace philox
