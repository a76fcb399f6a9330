// Multi-head attention forward and backward for head dims above 256, for
// Hopper (sm_90a), packed [B, T, H*D] layout.
//
// Replaces, for those head dims, the TPU kernel `mha_train`
// (few_shot_transformer_tts_tpu/ops/pallas_attention_train.py: `_fwd` with
// its body `_fwd_kernel`, and `_bwd_rule` with `_bwd_kernel`), which loops
// over the heads and keeps a whole K block in VMEM whatever D is.  It
// computes what mha_fwd.cu and mha_bwd.cu compute, at the same rounding
// points (see their headers): q * scale rounded to the input type before
// the dot, fp32 scores and softmax statistics, p rounded before P.V, o in
// the input type; the backward's g, do/keep and ds * scale rounded where
// the TPU kernel rounds them.  The dropout mask is philox.cuh's, the same
// bits as ops/mha.py `dropout_keep_mask`.
//
// Bound.  Like the narrower head dims, bytes bound it: at B=16, T=448,
// C=768 (2 heads of 384) the forward must move the same 44 MB as at 8
// heads of 96, 13 us at 3.35 TB/s.
//
// Design.  The per-head-dim kernels keep a row's D/2 output accumulators in
// registers and whole rows of q, k and v in shared memory; above D = 256
// neither fits.  Here the head dim is a runtime value (a multiple of 32, up
// to 1024; ops/mha.py pads any other), and the kernel streams it:
//   * scores: S = sum over 128-wide chunks c of q_c . k_c^T, each chunk of
//     the query tile and the key tile staged in shared memory in turn;
//   * outputs: a block owns 128 of the head's output columns (o, dq, or dk
//     and dv), grid y = heads x ceil(D / 128), and recomputes the scores
//     (and dP) at full D for them.
// So shared memory (four 32 x 129 fp32 tiles, 66 KB) and registers (4 x 4
// accumulators per output per lane) do not grow with D.  Blocks are the
// scalar kernels' layout: 32 rows (queries, or keys in the dk/dv kernel),
// 8 warps of 4 rows, 32-row streamed tiles with one lane per key or query,
// fp32 FMA from shared memory.  Both types run scalar: bf16 values are
// rounded where the TPU kernel rounds them and summed in fp32, so the
// tensor cores' layout buys nothing a first version needs.  The backward
// is two kernels with no atomics (deterministic), as in mha_bwd.cu: dq
// (and delta) by query blocks, dk/dv by key blocks.
//
// Interface: a plain C entry per direction, built once by nvcc into a
// shared library and loaded with ctypes (ops/cuda_build.py); the arguments
// are those of mha_fwd.cu and mha_bwd.cu.  Each launches on the given
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr float kNegInf = -1e20f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlock = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kTile = 32;                      // streamed rows per tile
constexpr int kChunk = 128;                    // head-dim chunk
constexpr int kLd = kChunk + 1;                // tile row stride (floats)
constexpr int kColsPerLane = kChunk / 32;
constexpr int kMaxHeadDim = 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const long long* seed;
  const void* o;
  float* lse;
  const void* dout;
  void* out0;  // forward: o; backward: dq
  void* dk;
  void* dv;
  float* delta;
  int tq, tk, num_heads, head_dim, n_col;
  long long q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, o_sb, o_sr, do_sb, do_sr;
  float scale;
  int causal, use_bias;
  unsigned threshold;
  float keep;  // forward: 1 - rate; backward: 1 / (1 - rate)
};

// rows r0.. of a [T, D] matrix (row stride sr, head offset applied),
// columns c0 .. c0 + n, into tile[kTile][kLd] as fp32 times mul, rounded to
// T when kRound; rows at or beyond n_rows and columns past n are zero
// (bf16: eight values per 16-byte load -- the wrapper holds bf16 rows to
// 16-byte aligned addresses and strides, and c0, n are multiples of 32)
template <typename T, bool kRound>
__device__ __forceinline__ void stage(float* tile, const T* base,
                                      long long sr, int r0, int n_rows,
                                      int c0, int n, float mul) {
  if constexpr (sizeof(T) == 2) {
    for (int i = threadIdx.x; i < kTile * kChunk / 8; i += kWarps * 32) {
      const int r = i / (kChunk / 8), c = (i - r * (kChunk / 8)) * 8;
      const int row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_rows && c < n)
        v = *reinterpret_cast<const uint4*>(base + row * sr + c0 + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        tile[r * kLd + c + 2 * j] = kRound ? rnd<T>(f.x * mul) : f.x * mul;
        tile[r * kLd + c + 2 * j + 1] =
            kRound ? rnd<T>(f.y * mul) : f.y * mul;
      }
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kChunk; i += kWarps * 32) {
      const int r = i / kChunk, c = i - r * kChunk, row = r0 + r;
      float x = 0.f;
      if (row < n_rows && c < n) {
        x = to_f(base[row * sr + c0 + c]) * mul;
        if (kRound) x = rnd<T>(x);
      }
      tile[r * kLd + c] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// forward: a block owns 32 query rows and 128 output columns of one head
// ---------------------------------------------------------------------------

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_wide_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [32][kLd] q chunk, scaled, rounded
  float* k_s = q_s + kTile * kLd;    // [32][kLd] k chunk
  float* v_s = k_s + kTile * kLd;    // [32][kLd] v, the block's columns
  float* p_s = v_s + kTile * kLd;    // [8][4][32] rounded p
  float* bias_s = p_s + kWarps * kRowsPerWarp * kTile;  // [32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlock, b = blockIdx.z;
  const int h = blockIdx.y / a.n_col, col0 = (blockIdx.y % a.n_col) * kChunk;
  const int D = a.head_dim, H = a.num_heads, tq = a.tq, tk = a.tk;
  const int n_out = min(kChunk, D - col0);
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.f;
  }

  const int k_end = a.causal ? min(tk, q0 + kBlock) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      const int n = min(kChunk, D - c0);
      __syncthreads();  // the previous chunk is consumed
      stage<T, true>(q_s, qb, a.q_sr, q0, tq, c0, n, a.scale);
      stage<T, false>(k_s, kb, a.k_sr, k0, tk, c0, n, 1.f);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < n; ++c) {
        const float kc = k_s[lane * kLd + c];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          s[i] = fmaf(q_s[(warp * kRowsPerWarp + i) * kLd + c], kc, s[i]);
      }
    }
    __syncthreads();
    stage<T, false>(v_s, vb, a.v_sr, k0, tk, col0, n_out, 1.f);
    if (tid < kTile) {
      const int kj = k0 + tid;
      bias_s[tid] = (a.use_bias && kj < tk) ? a.bias[(long long)b * tk + kj]
                                            : 0.f;
    }
    __syncthreads();

    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout)
      bits = philox::dropout_bits(sd, (k0 >> 2) + (lane & 7),
                                  q0 + warp * kRowsPerWarp + (lane >> 3), h,
                                  b);
    const int kj = k0 + lane;
    const bool valid = kj < tk;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp * kRowsPerWarp + i;
      float si = s[i] + bias_s[lane];
      if (a.causal && kj > qi) si = kNegInf;
      if (!valid) si = -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(si));
      float p = valid ? expf(si - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      l[i] = l[i] * alpha + warp_sum(p);       // l sums the unmasked p
      m[i] = m_new;
      if (kDropout) {
        const int src = i * 8 + (lane >> 2);
        const uint4 w = make_uint4(__shfl_sync(kFull, bits.x, src),
                                   __shfl_sync(kFull, bits.y, src),
                                   __shfl_sync(kFull, bits.z, src),
                                   __shfl_sync(kFull, bits.w, src));
        if (philox::word(w, lane & 3) < a.threshold) p = 0.f;
      }
      p_s[(warp * kRowsPerWarp + i) * kTile + lane] = rnd<T>(p);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const float vj = v_s[kk * kLd + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i][j] = fmaf(p_s[(warp * kRowsPerWarp + i) * kTile + kk], vj,
                           acc[i][j]);
      }
    }
  }

  T* ob = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    const float r = 1.f / fmaxf(kDropout ? l[i] * a.keep : l[i], 1e-30f);
    T* orow = ob + ((long long)b * tq + qi) * (H * D) + h * D + col0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (lane + 32 * j < n_out) orow[lane + 32 * j] = from_f<T>(acc[i][j] * r);
    if (lane == 0 && col0 == 0)
      a.lse[((long long)b * tq + qi) * H + h] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward, dq (and delta): a block owns 32 query rows, 128 dq columns
// ---------------------------------------------------------------------------

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_wide_dq_kernel(Args a) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // q chunk, scaled, rounded
  float* do_s = q_s + kTile * kLd;   // do chunk
  float* k_s = do_s + kTile * kLd;   // k chunk, then k of the block's cols
  float* v_s = k_s + kTile * kLd;    // v chunk
  float* ds_s = v_s + kTile * kLd;   // [8][4][32] rounded ds * scale
  float* bias_s = ds_s + kWarps * kRowsPerWarp * kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlock, b = blockIdx.z;
  const int h = blockIdx.y / a.n_col, col0 = (blockIdx.y % a.n_col) * kChunk;
  const int D = a.head_dim, H = a.num_heads, tq = a.tq, tk = a.tk;
  const int n_out = min(kChunk, D - col0);
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * D;
  const T* ob = static_cast<const T*>(a.o) + b * a.o_sb + h * D;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  // delta = rowsum(do . o) over the whole head, lse of the warp's rows
  float delta[kRowsPerWarp], lse[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    float part = 0.f;
    if (qi < tq)
      for (int d = lane; d < D; d += 32)
        part += to_f(dob[qi * a.do_sr + d]) * to_f(ob[qi * a.o_sr + d]);
    delta[i] = warp_sum(part);
    lse[i] = qi < tq ? a.lse[((long long)b * tq + qi) * H + h] : 0.f;
    if (lane == 0 && qi < tq && col0 == 0)
      a.delta[((long long)b * tq + qi) * H + h] = delta[i];
  }

  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.f;

  const int k_end = a.causal ? min(tk, q0 + kBlock) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    float s[kRowsPerWarp], dg[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dg[i] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      const int n = min(kChunk, D - c0);
      __syncthreads();
      stage<T, true>(q_s, qb, a.q_sr, q0, tq, c0, n, a.scale);
      stage<T, false>(do_s, dob, a.do_sr, q0, tq, c0, n, 1.f);
      stage<T, false>(k_s, kb, a.k_sr, k0, tk, c0, n, 1.f);
      stage<T, false>(v_s, vb, a.v_sr, k0, tk, c0, n, 1.f);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < n; ++c) {
        const float kc = k_s[lane * kLd + c], vc = v_s[lane * kLd + c];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = (warp * kRowsPerWarp + i) * kLd + c;
          s[i] = fmaf(q_s[r], kc, s[i]);
          dg[i] = fmaf(do_s[r], vc, dg[i]);
        }
      }
    }
    __syncthreads();
    stage<T, false>(k_s, kb, a.k_sr, k0, tk, col0, n_out, 1.f);
    if (tid < kTile) {
      const int kj = k0 + tid;
      bias_s[tid] = (a.use_bias && kj < tk) ? a.bias[(long long)b * tk + kj]
                                            : 0.f;
    }
    __syncthreads();

    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout)
      bits = philox::dropout_bits(sd, (k0 >> 2) + (lane & 7),
                                  q0 + warp * kRowsPerWarp + (lane >> 3), h,
                                  b);
    const int kj = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp * kRowsPerWarp + i;
      float si = s[i] + bias_s[lane];
      if (a.causal && kj > qi) si = kNegInf;
      const float p = (kj < tk && qi < tq) ? expf(si - lse[i]) : 0.f;
      float dw = dg[i];
      if (kDropout) {
        const int src = i * 8 + (lane >> 2);
        const uint4 w = make_uint4(__shfl_sync(kFull, bits.x, src),
                                   __shfl_sync(kFull, bits.y, src),
                                   __shfl_sync(kFull, bits.z, src),
                                   __shfl_sync(kFull, bits.w, src));
        dw = philox::word(w, lane & 3) >= a.threshold ? dw * a.keep : 0.f;
      }
      ds_s[(warp * kRowsPerWarp + i) * kTile + lane] =
          rnd<T>(p * (dw - delta[i]) * a.scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const float kv = k_s[kk * kLd + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i][j] = fmaf(ds_s[(warp * kRowsPerWarp + i) * kTile + kk], kv,
                           acc[i][j]);
      }
    }
  }

  T* dqb = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    T* row = dqb + ((long long)b * tq + qi) * (H * D) + h * D + col0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (lane + 32 * j < n_out) row[lane + 32 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block owns 32 keys and 128 columns of each
// ---------------------------------------------------------------------------

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_wide_dkdv_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs_s = smem;                 // q chunk scaled, rounded; then raw q
  float* do_s = qs_s + kTile * kLd;   // do chunk; then round(do / keep)
  float* k_s = do_s + kTile * kLd;    // k chunk of the block's keys
  float* v_s = k_s + kTile * kLd;     // v chunk of the block's keys
  float* g_s = v_s + kTile * kLd;     // [8][4][32] rounded g
  float* ds_s = g_s + kWarps * kRowsPerWarp * kTile;  // rounded ds * scale
  float* lse_s = ds_s + kWarps * kRowsPerWarp * kTile;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kBlock, b = blockIdx.z;
  const int h = blockIdx.y / a.n_col, col0 = (blockIdx.y % a.n_col) * kChunk;
  const int D = a.head_dim, H = a.num_heads, tq = a.tq, tk = a.tk;
  const int n_out = min(kChunk, D - col0);
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * D;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  const int key0 = k0 + warp * kRowsPerWarp;  // the warp's first key
  float bias_k[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    bias_k[i] = (a.use_bias && key0 + i < tk)
                    ? a.bias[(long long)b * tk + key0 + i]
                    : 0.f;

  float dk[kRowsPerWarp][kColsPerLane], dv[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: queries before the block's first key see none of its keys
  for (int q0 = a.causal ? k0 : 0; q0 < tq; q0 += kTile) {
    float s[kRowsPerWarp], dg[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dg[i] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      const int n = min(kChunk, D - c0);
      __syncthreads();
      stage<T, true>(qs_s, qb, a.q_sr, q0, tq, c0, n, a.scale);
      stage<T, false>(do_s, dob, a.do_sr, q0, tq, c0, n, 1.f);
      stage<T, false>(k_s, kb, a.k_sr, k0, tk, c0, n, 1.f);
      stage<T, false>(v_s, vb, a.v_sr, k0, tk, c0, n, 1.f);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < n; ++c) {
        const float qc = qs_s[lane * kLd + c], dc = do_s[lane * kLd + c];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = (warp * kRowsPerWarp + i) * kLd + c;
          s[i] = fmaf(qc, k_s[r], s[i]);
          dg[i] = fmaf(dc, v_s[r], dg[i]);
        }
      }
    }
    __syncthreads();
    stage<T, false>(qs_s, qb, a.q_sr, q0, tq, col0, n_out, 1.f);
    stage<T, true>(do_s, dob, a.do_sr, q0, tq, col0, n_out, a.keep);
    if (tid < kTile) {
      const int qi = q0 + tid;
      const bool in = qi < tq;
      lse_s[tid] = in ? a.lse[((long long)b * tq + qi) * H + h] : 0.f;
      delta_s[tid] = in ? a.delta[((long long)b * tq + qi) * H + h] : 0.f;
    }
    __syncthreads();

    const int qj = q0 + lane;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout) bits = philox::dropout_bits(sd, key0 >> 2, qj, h, b);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int kj = key0 + i;
      float si = s[i] + bias_k[i];
      if (a.causal && kj > qj) si = kNegInf;
      const float p = (kj < tk && qj < tq) ? expf(si - lse_s[lane]) : 0.f;
      float g = p, dw = dg[i];
      if (kDropout) {
        const bool keep = philox::word(bits, i) >= a.threshold;
        g = keep ? p : 0.f;
        dw = keep ? dw * a.keep : 0.f;
      }
      g_s[(warp * kRowsPerWarp + i) * kTile + lane] = rnd<T>(g);
      ds_s[(warp * kRowsPerWarp + i) * kTile + lane] =
          rnd<T>(p * (dw - delta_s[lane]) * a.scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const float dok = do_s[qq * kLd + lane + 32 * j];
        const float qr = qs_s[qq * kLd + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = (warp * kRowsPerWarp + i) * kTile + qq;
          dv[i][j] = fmaf(g_s[r], dok, dv[i][j]);
          dk[i][j] = fmaf(ds_s[r], qr, dk[i][j]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int kj = key0 + i;
    if (kj >= tk) continue;
    const long long off = ((long long)b * tk + kj) * (H * D) + h * D + col0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (lane + 32 * j < n_out) {
        dkb[off + lane + 32 * j] = from_f<T>(dk[i][j]);
        dvb[off + lane + 32 * j] = from_f<T>(dv[i][j]);
      }
  }
}

constexpr int kFwdSmem =
    (3 * kTile * kLd + kWarps * kRowsPerWarp * kTile + kTile) * 4;
constexpr int kDqSmem =
    (4 * kTile * kLd + kWarps * kRowsPerWarp * kTile + kTile) * 4;
constexpr int kDkdvSmem =
    (4 * kTile * kLd + 2 * kWarps * kRowsPerWarp * kTile + 2 * kTile) * 4;

// dynamic shared memory above 48 KB needs the opt-in, once per kernel
template <typename K>
cudaError_t opt_in(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <typename T, bool kDropout>
cudaError_t launch_fwd(const Args& a, int batch, cudaStream_t s) {
  static bool done = false;
  cudaError_t e = opt_in(mha_wide_fwd_kernel<T, kDropout>, kFwdSmem, &done);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.tq + kBlock - 1) / kBlock, a.num_heads * a.n_col,
                  batch);
  mha_wide_fwd_kernel<T, kDropout><<<grid, kWarps * 32, kFwdSmem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kDropout>
cudaError_t launch_bwd(const Args& a, int batch, cudaStream_t s) {
  static bool done_q = false, done_k = false;
  cudaError_t e = opt_in(mha_wide_dq_kernel<T, kDropout>, kDqSmem, &done_q);
  if (e != cudaSuccess) return e;
  e = opt_in(mha_wide_dkdv_kernel<T, kDropout>, kDkdvSmem, &done_k);
  if (e != cudaSuccess) return e;
  const dim3 grid_q((a.tq + kBlock - 1) / kBlock, a.num_heads * a.n_col,
                    batch);
  mha_wide_dq_kernel<T, kDropout><<<grid_q, kWarps * 32, kDqSmem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 grid_k((a.tk + kBlock - 1) / kBlock, a.num_heads * a.n_col,
                    batch);
  mha_wide_dkdv_kernel<T, kDropout><<<grid_k, kWarps * 32, kDkdvSmem, s>>>(
      a);
  return cudaGetLastError();
}

bool bad_head_dim(int dtype, int head_dim) {
  return (dtype != 0 && dtype != 1) || head_dim < 32 ||
         head_dim > kMaxHeadDim || head_dim % 32;
}

}  // namespace

// As mha_fwd (mha_fwd.cu), for head dims that are a multiple of 32 up to
// 1024 (any such D; refused otherwise).
extern "C" int mha_wide_fwd(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* bias,
                            const void* seed, void* o, void* lse, int batch,
                            int tq, int tk, int num_heads, long long q_sb,
                            long long q_sr, long long k_sb, long long k_sr,
                            long long v_sb, long long v_sr, float scale,
                            int causal, int use_bias, int dropout,
                            unsigned threshold, float keep_prob,
                            void* stream) {
  if (bad_head_dim(dtype, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.seed = static_cast<const long long*>(seed);
  a.out0 = o;
  a.lse = static_cast<float*>(lse);
  a.tq = tq;
  a.tk = tk;
  a.num_heads = num_heads;
  a.head_dim = head_dim;
  a.n_col = (head_dim + kChunk - 1) / kChunk;
  a.q_sb = q_sb;
  a.q_sr = q_sr;
  a.k_sb = k_sb;
  a.k_sr = k_sr;
  a.v_sb = v_sb;
  a.v_sr = v_sr;
  a.scale = scale;
  a.causal = causal;
  a.use_bias = use_bias;
  a.threshold = threshold;
  a.keep = keep_prob;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(
        dropout ? launch_fwd<__nv_bfloat16, true>(a, batch, s)
                : launch_fwd<__nv_bfloat16, false>(a, batch, s));
  return static_cast<int>(dropout ? launch_fwd<float, true>(a, batch, s)
                                  : launch_fwd<float, false>(a, batch, s));
}

// As mha_bwd (mha_bwd.cu), for head dims that are a multiple of 32 up to
// 1024.
extern "C" int mha_wide_bwd(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* bias,
                            const void* seed, const void* o, const void* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            void* delta, int batch, int tq, int tk,
                            int num_heads, long long q_sb, long long q_sr,
                            long long k_sb, long long k_sr, long long v_sb,
                            long long v_sr, long long o_sb, long long o_sr,
                            long long do_sb, long long do_sr, float scale,
                            int causal, int use_bias, int dropout,
                            unsigned threshold, float inv_keep,
                            void* stream) {
  if (bad_head_dim(dtype, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.seed = static_cast<const long long*>(seed);
  a.o = o;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dout = dout;
  a.out0 = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = static_cast<float*>(delta);
  a.tq = tq;
  a.tk = tk;
  a.num_heads = num_heads;
  a.head_dim = head_dim;
  a.n_col = (head_dim + kChunk - 1) / kChunk;
  a.q_sb = q_sb;
  a.q_sr = q_sr;
  a.k_sb = k_sb;
  a.k_sr = k_sr;
  a.v_sb = v_sb;
  a.v_sr = v_sr;
  a.o_sb = o_sb;
  a.o_sr = o_sr;
  a.do_sb = do_sb;
  a.do_sr = do_sr;
  a.scale = scale;
  a.causal = causal;
  a.use_bias = use_bias;
  a.threshold = threshold;
  a.keep = inv_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(
        dropout ? launch_bwd<__nv_bfloat16, true>(a, batch, s)
                : launch_bwd<__nv_bfloat16, false>(a, batch, s));
  return static_cast<int>(dropout ? launch_bwd<float, true>(a, batch, s)
                                  : launch_bwd<float, false>(a, batch, s));
}

extern "C" const char* mha_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
