// Multi-head attention forward for Hopper (sm_90a), packed [B, T, H*D] layout.
//
// Replaces the forward of the TPU kernel `mha_train`
// (few_shot_transformer_tts_tpu/ops/pallas_attention_train.py, `_fwd` and
// its body `_fwd_kernel`).  Per (batch, head, query row):
//
//   s   = (q * scale, rounded to the input type) . k^T      fp32
//   s  += bias[b, key]                 (use_bias: key padding, -1e20)
//   s   = -1e20 where key > query      (causal)
//   m   = max_k s,  l = sum_k exp(s - m),  lse = m + log l  (fp32, [B,Tq,H])
//   g   = p where the dropout mask keeps the key, else 0    (rate > 0)
//   o   = (sum_k round(g_k) v_k) * 1/max(l * keep, 1e-30)   (input type)
//
// Dropout follows the TPU kernel: the mask applies to the unnormalized p,
// l sums the unmasked p, and 1/keep is folded into the output scale.  The
// mask bits come from philox.cuh, a pure function of (seed, b, h, q, k), so
// the backward (mha_bwd.cu) regenerates them.  Rate 0 is its own template
// instantiation with no mask code.  Keys at or beyond Tk are excluded (the
// TPU kernel pads them at -1e30, whose exponent is exactly 0 in fp32).
//
// Design.  The TPU kernel keeps a whole K/V (up to 2048 x 768) in VMEM; a
// Hopper block has at most 227 KB of shared memory, so here a block owns 32
// query rows of one (batch, head) -- grid (ceil(Tq/32), H, B) -- and streams
// K/V through shared memory in 32-key tiles with an online softmax in fp32.
// Causal blocks stop at the last key their rows can see.  Each of the 8 warps
// owns 4 query rows; lane j computes the scores of key j for those rows, the
// row max and sum are warp shuffles, and for P.V lane j accumulates the
// output dims j, j+32 (and j+64 at D=96).  With dropout, each lane draws one
// Philox block (4 keys of one row) per tile, and the words reach the lanes
// that own those keys by shuffles: one generator call per 4 scores.  q, k
// and v are read through their row strides, so the split views of a fused
// QKV projection need no copy and no head transpose.  Arithmetic is scalar
// fp32 FMA from shared memory: the kernel is simple and exact first; tensor
// cores (mma/wgmma) and TMA are later work.
//
// Bound.  The function must read q, k, v and bias once and write o and lse
// once: at the flagship encoder shape (B=8, T=192, C=512, bf16) that is about
// 6.3 MB, 1.9 us at 3.35 TB/s, against 0.6 GFLOP = 0.6 us at the 989 TFLOP/s
// bf16 tensor-core rate -- bytes bound it.  This scalar kernel runs far from
// that bound; PERF.md holds its measured times.
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                      // keys per shared-memory tile
constexpr float kNegInf = -1e20f;                // causal mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 value to T's precision and back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               const long long* __restrict__ seed, T* __restrict__ o,
               float* __restrict__ lse, int tq, int tk, int num_heads,
               long long q_sb, long long q_sr,
               long long k_sb, long long k_sr,
               long long v_sb, long long v_sr,
               float scale, int causal, int use_bias, unsigned threshold,
               float keep_prob) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDimsPerLane = D / 32;

  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];  // +1: lane j reads row j, no conflicts
  __shared__ float v_s[kBlockK][D];
  __shared__ float p_s[kWarps][kRowsPerWarp][kBlockK];
  __shared__ float bias_s[kBlockK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * D;
  const T* kb = k + b * k_sb + h * D;
  const T* vb = v + b * v_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*seed);

  // q tile, scaled in fp32 and rounded back to the input type (as the TPU
  // kernel does before its dot); rows beyond Tq are zero and never stored.
  for (int idx = tid; idx < kBlockQ * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int qi = q0 + r;
    q_s[r][c] = qi < tq ? round_to<T>(to_float(qb[qi * q_sr + c]) * scale)
                        : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDimsPerLane; ++d) acc[i][d] = 0.f;
  }

  // causal rows of this block see no key beyond q0 + kBlockQ - 1
  const int k_end = causal ? min(tk, q0 + kBlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * D; idx += blockDim.x) {
      const int r = idx / D, c = idx - (idx / D) * D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < tk) {
        kv = to_float(kb[kj * k_sr + c]);
        vv = to_float(vb[kj * v_sr + c]);
      }
      k_s[r][c] = kv;
      v_s[r][c] = vv;
    }
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      bias_s[tid] = (use_bias && kj < tk) ? bias[(long long)b * tk + kj] : 0.f;
    }
    __syncthreads();

    // lane l draws keys k0 + 4*(l&7) .. +3 of row l>>3 of this warp
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout)
      bits = philox::dropout_bits(sd, (k0 >> 2) + (lane & 7),
                                  q0 + warp * kRowsPerWarp + (lane >> 3), h,
                                  b);

    const int kj = k0 + lane;
    const bool valid = kj < tk;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = k_s[lane][c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(q_s[warp * kRowsPerWarp + i][c], kc, s[i]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp * kRowsPerWarp + i;
      float si = s[i];
      if (use_bias) si += bias_s[lane];
      if (causal && kj > qi) si = kNegInf;
      if (!valid) si = -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(si));
      float p = valid ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      l[i] = l[i] * alpha + warp_sum(p);       // l sums the unmasked p
      m[i] = m_new;
      if (kDropout) {
        const int src = i * 8 + (lane >> 2);
        const uint4 w = make_uint4(__shfl_sync(0xffffffffu, bits.x, src),
                                   __shfl_sync(0xffffffffu, bits.y, src),
                                   __shfl_sync(0xffffffffu, bits.z, src),
                                   __shfl_sync(0xffffffffu, bits.w, src));
        if (philox::word(w, lane & 3) < threshold) p = 0.f;
      }
      // the TPU kernel casts p to v's type before the P.V product
      p_s[warp][i][lane] = round_to<T>(p);
#pragma unroll
      for (int d = 0; d < kDimsPerLane; ++d) acc[i][d] *= alpha;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int d = 0; d < kDimsPerLane; ++d) {
        const float vj = v_s[j][lane + 32 * d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i][d] = fmaf(p_s[warp][i][j], vj, acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    const float r = 1.f / fmaxf(kDropout ? l[i] * keep_prob : l[i], 1e-30f);
    T* orow = o + ((long long)b * tq + qi) * (num_heads * D) + h * D;
#pragma unroll
    for (int d = 0; d < kDimsPerLane; ++d)
      orow[lane + 32 * d] = from_float<T>(acc[i][d] * r);
    if (lane == 0)
      lse[((long long)b * tq + qi) * num_heads + h] = m[i] + logf(l[i]);
  }
}

template <typename T, int D, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* seed, void* o, void* lse,
                   int batch, int tq, int tk, int num_heads, long long q_sb,
                   long long q_sr, long long k_sb, long long k_sr,
                   long long v_sb, long long v_sr, float scale, int causal,
                   int use_bias, unsigned threshold, float keep_prob,
                   cudaStream_t stream) {
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, num_heads, batch);
  mha_fwd_kernel<T, D, kDropout><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const long long*>(seed), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, num_heads, q_sb, q_sr, k_sb, k_sr,
      v_sb, v_sr, scale, causal, use_bias, threshold, keep_prob);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rate(bool dropout, const void* q, const void* k,
                          const void* v, const void* bias, const void* seed,
                          void* o, void* lse, int batch, int tq, int tk,
                          int num_heads, long long q_sb, long long q_sr,
                          long long k_sb, long long k_sr, long long v_sb,
                          long long v_sr, float scale, int causal,
                          int use_bias, unsigned threshold, float keep_prob,
                          cudaStream_t stream) {
  if (dropout)
    return launch<T, D, true>(q, k, v, bias, seed, o, lse, batch, tq, tk,
                              num_heads, q_sb, q_sr, k_sb, k_sr, v_sb, v_sr,
                              scale, causal, use_bias, threshold, keep_prob,
                              stream);
  return launch<T, D, false>(q, k, v, bias, seed, o, lse, batch, tq, tk,
                             num_heads, q_sb, q_sr, k_sb, k_sr, v_sb, v_sr,
                             scale, causal, use_bias, threshold, keep_prob,
                             stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 96.  Strides are in
// elements; the last dim of q, k, v must be contiguous.  bias is [B, Tk]
// float32 (ignored unless use_bias).  seed points at one int64 on the device
// (read only when dropout != 0); a key is kept when its Philox word is >=
// threshold, and keep_prob = 1 - rate scales the output.  o is [B, Tq, H*D]
// in the input type, lse [B, Tq, H] float32, both contiguous.
extern "C" int mha_fwd(int dtype, int head_dim, const void* q, const void* k,
                       const void* v, const void* bias, const void* seed,
                       void* o, void* lse, int batch, int tq, int tk,
                       int num_heads, long long q_sb, long long q_sr,
                       long long k_sb, long long k_sr, long long v_sb,
                       long long v_sr, float scale, int causal, int use_bias,
                       int dropout, unsigned threshold, float keep_prob,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
#define MHA_ARGS                                                             \
  drop, q, k, v, bias, seed, o, lse, batch, tq, tk, num_heads, q_sb, q_sr,  \
      k_sb, k_sr, v_sb, v_sr, scale, causal, use_bias, threshold, keep_prob, \
      s
  if (dtype == 0 && head_dim == 64) return dispatch_rate<float, 64>(MHA_ARGS);
  if (dtype == 0 && head_dim == 96) return dispatch_rate<float, 96>(MHA_ARGS);
  if (dtype == 1 && head_dim == 64)
    return dispatch_rate<__nv_bfloat16, 64>(MHA_ARGS);
  if (dtype == 1 && head_dim == 96)
    return dispatch_rate<__nv_bfloat16, 96>(MHA_ARGS);
#undef MHA_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mha_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
