// Tensor-core building blocks of the bf16 attention kernels (mha_fwd.cu,
// mha_bwd.cu, mha_wide.cu): 16-byte asynchronous copies into shared memory,
// ldmatrix and mma.sync m16n8k16 (bf16 operands, fp32 accumulators), as
// sm_80+ PTX.
//
// Fragment layout of mma.m16n8k16 for lane = 4 * g + t (g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                           a3 (g+8, 2t+8..)
//   B (16 x 8)              b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32)        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// so an accumulator pair (c0, c1) of two n-tiles side by side is the A
// operand of the next product without leaving registers.
//
// Tiles in shared memory are row major with a row stride of D + 8 bf16
// (16 bytes of padding): the eight 16-byte rows that one ldmatrix phase
// reads then fall on distinct banks, and every row stays 16-byte aligned
// for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !pred nothing is read and the 16 bytes
// are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i in the A/B fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The same, each matrix transposed on the way (for a B operand whose
// reduction dim runs down the rows in shared memory).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a . b on the tensor cores (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Eight bf16 values times s in fp32, rounded back to bf16.
__device__ __forceinline__ uint4 scale_bf16x8(uint4 x, float s) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16(w[i]);
    w[i] = pack_bf16(f.x * s, f.y * s);
  }
  return x;
}

// Sum of the eight products of two 16-byte bf16 vectors, in fp32.
__device__ __forceinline__ float dot_bf16x8(uint4 x, uint4 y) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&y);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = unpack_bf16(u[i]), b = unpack_bf16(w[i]);
    sum += a.x * b.x;
    sum += a.y * b.y;
  }
  return sum;
}

// The A fragment of a 16 x 16 product from the fp32 accumulators of two
// neighbouring n-tiles (columns 0-7 and 8-15), each rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* c0,
                                         const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Shared-memory address of this lane's row for ldmatrix_x4 of a 16 x 16
// A operand at (row0, col0) of a row-major tile with row stride S.
template <int S>
__device__ __forceinline__ const __nv_bfloat16* a_rows(
    const __nv_bfloat16* tile, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 15)) * S + col0 + (lane >> 4) * 8;
}

// ... of two 8-wide n-tiles of a B operand stored n-major (rows n0..n0+15
// hold the columns of B, reduction dim along the row): registers 0, 1 are
// b0, b1 of n-tile n0..n0+7 and registers 2, 3 those of n0+8..n0+15.
template <int S>
__device__ __forceinline__ const __nv_bfloat16* b_rows(
    const __nv_bfloat16* tile, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * S + k0 +
         ((lane >> 3) & 1) * 8;
}

// ... of a B operand stored k-major (rows k0..k0+15 are the reduction dim,
// columns n0..n0+15 along the row), for ldmatrix_x4_trans: registers 0, 1
// are b0, b1 of columns n0..n0+7 and registers 2, 3 of n0+8..n0+15.
template <int S>
__device__ __forceinline__ const __nv_bfloat16* bt_rows(
    const __nv_bfloat16* tile, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * S + n0 +
         (lane >> 4) * 8;
}

}  // namespace tc
