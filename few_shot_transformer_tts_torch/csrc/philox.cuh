// Dropout bits for the attention kernels: Philox-4x32-10 (Salmon et al.,
// "Parallel random numbers: as easy as 1, 2, 3", SC 2011), keyed by the
// 64-bit seed, with the counter (key / 4, query, head, batch).  One call
// gives the bits of four consecutive keys of one (batch, head, query), so the
// mask is a pure function of (seed, b, h, q, k): the backward regenerates it
// and no [B, H, Tq, Tk] mask reaches memory.  A key is kept when its 32-bit
// word is >= threshold = uint32(rate * 2^32), the threshold rule of the TPU
// kernel's `_mask_from_bits`.  The head is the layer's: a kernel passes its
// block's head plus the call's head_offset, so a tensor-parallel rank that
// holds some of a layer's heads draws the layer's mask of those heads.
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

// The dropped elements of one tile of kJ 8-wide column tiles (64 or 32
// wide) in the mma accumulator layout of the bf16 kernels
// (tensor_core.cuh): bit 4j + e is set when element e of column tile j is
// dropped.  Each lane draws kJ Philox blocks, one per 4 of its 4 kJ
// elements, and trades two words of each with the lane that holds the
// other half of it.  Neither depends on shared memory, so a
// kernel draws them while its tile's copy is in flight.
//
// Forward and dq kernels: lane 4g + t holds queries row0 (elements 0, 1)
// and row0 + 8 (2, 3), keys k0 + 8j + 2t + {0, 1}; k0 is a multiple of 64.
// Those keys are words 2(t&1), 2(t&1)+1 of block (k0/4 + 2j + t/2): the
// even lane of a pair draws the block of row0, the odd one that of
// row0 + 8, and each hands the other the two words it needs.
template <int kJ = 8>
__device__ __forceinline__ unsigned tile_drop_bits(unsigned long long seed,
                                                   int k0, int row0, int h,
                                                   int b, unsigned threshold,
                                                   int t) {
  const bool odd = t & 1;
  const int q = row0 + (odd ? 8 : 0);
  unsigned drop = 0;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const uint4 w = dropout_bits(seed, (k0 >> 2) + 2 * j + (t >> 1), q, h, b);
    const unsigned own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
    const unsigned got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
    const unsigned got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
    const unsigned e0 = odd ? got0 : own0, e1 = odd ? got1 : own1;
    const unsigned e2 = odd ? own0 : got0, e3 = odd ? own1 : got1;
    drop |= (static_cast<unsigned>(e0 < threshold) |
             static_cast<unsigned>(e1 < threshold) << 1 |
             static_cast<unsigned>(e2 < threshold) << 2 |
             static_cast<unsigned>(e3 < threshold) << 3)
            << (4 * j);
  }
  return drop;
}

// dk/dv kernel, the transposed layout: lane 4g + t holds keys key0 =
// kbase + 2g (elements 0, 1) and key0 + 1 (2, 3), key0 even, of queries
// q0 + 8j + 2t + {0, 1}.  Those keys are words 2(g&1), 2(g&1)+1 of block
// (key0/4, query): the lane with g even draws the block of query
// q0 + 8j + 2t, the one with g odd (4 lanes on) that of the next query, and
// each hands the other the two words it needs.
//
// The dk/dv kernel holds 96 fp32 accumulators at D=96: with the ten round
// keys hoisted out of its tile loop and eight generator chains in flight it
// took 255 registers and spilled.  So here the seed passes an empty asm
// (the round keys are derived per tile, not held through the products) and
// four chains run at a time: 238 registers, no spill (ptxas, sm_90a).
template <int kJ = 8>
__device__ __forceinline__ unsigned tile_drop_bits_t(unsigned long long seed,
                                                     int key0, int q0, int h,
                                                     int b,
                                                     unsigned threshold,
                                                     int g, int t) {
  const bool odd = g & 1;
  unsigned long long sd = seed;
  asm volatile("" : "+l"(sd));
  unsigned drop = 0;
#pragma unroll 4
  for (int j = 0; j < kJ; ++j) {
    const uint4 w = dropout_bits(sd, key0 >> 2, q0 + 8 * j + 2 * t + odd, h,
                                 b);
    const unsigned own0 = odd ? w.z : w.x, own1 = odd ? w.w : w.y;
    const unsigned got0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 4);
    const unsigned got1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 4);
    const unsigned e0 = odd ? got0 : own0, e1 = odd ? own0 : got0;
    const unsigned e2 = odd ? got1 : own1, e3 = odd ? own1 : got1;
    drop |= (static_cast<unsigned>(e0 < threshold) |
             static_cast<unsigned>(e1 < threshold) << 1 |
             static_cast<unsigned>(e2 < threshold) << 2 |
             static_cast<unsigned>(e3 < threshold) << 3)
            << (4 * j);
  }
  return drop;
}

}  // namespace philox
