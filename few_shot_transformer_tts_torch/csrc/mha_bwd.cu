// Multi-head attention backward for Hopper (sm_90a), packed [B, T, H*D].
//
// Replaces the TPU kernel's backward: `_bwd_rule` and its body `_bwd_kernel`
// in few_shot_transformer_tts_tpu/ops/pallas_attention_train.py.  Given the
// forward's q, k, v, bias, seed, o and lse (mha_fwd.cu) and the output
// gradient do, per (batch, head):
//
//   p     = exp(s - lse)                 s recomputed as in the forward
//   delta = rowsum(do . o)               do and o taken to fp32
//   keep  = the forward's dropout mask   (philox.cuh, regenerated)
//   dv    = round(g)^T . round(do / keep)           g = keep ? p : 0
//   dw    = keep ? (do . v^T) / keep : 0
//   ds    = p * (dw - delta)
//   dss   = round(ds * scale)            one rectangle feeds dq and dk
//   dq    = dss . k,   dk = dss^T . q_raw           (fp32 sums, input type)
//
// "round" is a cast to the input type, at the TPU kernel's rounding points.
// The bias gets no gradient.
//
// Design.  The TPU kernel keeps the whole K in VMEM and accumulates dk/dv in
// its output block across sequential q tiles; Hopper blocks run in parallel
// and in no order, so here two kernels split the work with no atomics (the
// sums are deterministic):
//   * mha_bwd_dq: grid (ceil(Tq/32), H, B), the forward's layout.  A block
//     owns 32 query rows, computes delta for them (and writes it for the
//     second kernel), then streams 32-key tiles of K/V (causal: up to its
//     last visible key).  Lane j owns key j of the tile for the 4 rows of
//     its warp (scores, do.v^T, ds); dq accumulates in registers, lane j
//     holding dims j, j+32 (, j+64).
//   * mha_bwd_dkdv: grid (ceil(Tk/32), H, B).  A block owns 32 keys, warp w
//     the 4 keys 4w..4w+3, and streams 32-query tiles (causal: from its own
//     first key on).  Lane j owns query j of the tile; one Philox call gives
//     the mask words of the warp's 4 keys for that query.  dk and dv
//     accumulate in registers over all query tiles.
// Both run after one another on the stream; dq's delta is the second's input.
// Scalar fp32 FMA from shared memory (dynamic, above 48 KB at D=96); tensor
// cores (mma/wgmma) and TMA are later work.
//
// Bound.  Reads q, k, v, o, do, lse (and bias) once and writes dq, dk, dv:
// at the decoder's causal shape (B=16, T=448, C=768, bf16) about 88 MB, 26 us
// at 3.35 TB/s, against five products (s, do.v^T, dv, dq, dk) over the
// causal half = 12.4 GFLOP, 12.5 us at 989 TFLOP/s -- bytes bound it.
// PERF.md holds the measured times.
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches both kernels on the given stream, allocates nothing (delta is a
// [B, Tq, H] fp32 workspace from the caller), and returns the first launch
// error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlock = kWarps * kRowsPerWarp;  // rows (queries or keys)
constexpr int kTile = 32;                      // streamed tile (keys or queries)
constexpr float kNegInf = -1e20f;

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

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const long long* seed;
  const void* o;
  const float* lse;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* delta;
  int tq, tk, num_heads;
  long long q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, o_sb, o_sr, do_sb, do_sr;
  float scale;
  int causal, use_bias;
  unsigned threshold;
  float inv_keep;
};

template <int D>
constexpr int dq_smem_bytes() {
  // qs[32][D], do[32][D], k[32][D+1], v[32][D+1], ds[8][4][32], bias[32]
  return (2 * kBlock * D + 2 * kTile * (D + 1) +
          kWarps * kRowsPerWarp * kTile + kTile) * 4;
}

template <int D>
constexpr int dkdv_smem_bytes() {
  // k[32][D], v[32][D], qs[32][D+1], do[32][D+1], qraw[32][D], dok[32][D],
  // g[8][4][32], ds[8][4][32], lse[32], delta[32]
  return (4 * kBlock * D + 2 * kTile * (D + 1) +
          2 * kWarps * kRowsPerWarp * kTile + 2 * kTile) * 4;
}

// ---------------------------------------------------------------------------
// dq (and delta): a block owns 32 query rows of one (batch, head)
// ---------------------------------------------------------------------------
template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_bwd_dq(Args a) {
  constexpr int kDims = D / 32;
  extern __shared__ float smem[];
  float(*qs_s)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*do_s)[D] = qs_s + kBlock;
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(do_s + kBlock);
  float(*v_s)[D + 1] = k_s + kTile;
  float(*ds_s)[kRowsPerWarp][kTile] =
      reinterpret_cast<float(*)[kRowsPerWarp][kTile]>(v_s + kTile);
  float* bias_s = reinterpret_cast<float*>(ds_s + kWarps);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int tq = a.tq, tk = a.tk, H = a.num_heads;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * D;
  const T* ob = static_cast<const T*>(a.o) + b * a.o_sb + h * D;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  for (int idx = tid; idx < kBlock * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D, qi = q0 + r;
    const bool in = qi < tq;
    qs_s[r][c] = in ? round_to<T>(to_float(qb[qi * a.q_sr + c]) * a.scale)
                    : 0.f;
    do_s[r][c] = in ? to_float(dob[qi * a.do_sr + c]) : 0.f;
  }
  __syncthreads();

  // delta = rowsum(do . o) and lse of the warp's rows
  float delta[kRowsPerWarp], lse[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i, qi = q0 + r;
    float part = 0.f;
    if (qi < tq) {
#pragma unroll
      for (int d = 0; d < kDims; ++d)
        part += do_s[r][lane + 32 * d] *
                to_float(ob[qi * a.o_sr + lane + 32 * d]);
    }
    delta[i] = warp_sum(part);
    lse[i] = qi < tq ? a.lse[((long long)b * tq + qi) * H + h] : 0.f;
    if (lane == 0 && qi < tq)
      a.delta[((long long)b * tq + qi) * H + h] = delta[i];
  }

  float acc[kRowsPerWarp][kDims];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[i][d] = 0.f;

  const int k_end = a.causal ? min(tk, q0 + kBlock) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * D; idx += blockDim.x) {
      const int r = idx / D, c = idx - r * D, kj = k0 + r;
      const bool in = kj < tk;
      k_s[r][c] = in ? to_float(kb[kj * a.k_sr + c]) : 0.f;
      v_s[r][c] = in ? to_float(vb[kj * a.v_sr + c]) : 0.f;
    }
    if (tid < kTile) {
      const int kj = k0 + tid;
      bias_s[tid] =
          (a.use_bias && kj < tk) ? a.bias[(long long)b * tk + kj] : 0.f;
    }
    __syncthreads();

    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout)
      bits = philox::dropout_bits(sd, (k0 >> 2) + (lane & 7),
                                  q0 + warp * kRowsPerWarp + (lane >> 3), h,
                                  b);

    const int kj = k0 + lane;
    float s[kRowsPerWarp], dg[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dg[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = k_s[lane][c], vc = v_s[lane][c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = fmaf(qs_s[warp * kRowsPerWarp + i][c], kc, s[i]);
        dg[i] = fmaf(do_s[warp * kRowsPerWarp + i][c], vc, dg[i]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp * kRowsPerWarp + i;
      float si = s[i] + (a.use_bias ? bias_s[lane] : 0.f);
      if (a.causal && kj > qi) si = kNegInf;
      const float p = (kj < tk && qi < tq) ? expf(si - lse[i]) : 0.f;
      float dw = dg[i];
      if (kDropout) {
        const int src = i * 8 + (lane >> 2);
        const uint4 w = make_uint4(__shfl_sync(0xffffffffu, bits.x, src),
                                   __shfl_sync(0xffffffffu, bits.y, src),
                                   __shfl_sync(0xffffffffu, bits.z, src),
                                   __shfl_sync(0xffffffffu, bits.w, src));
        dw = philox::word(w, lane & 3) >= a.threshold ? dw * a.inv_keep : 0.f;
      }
      ds_s[warp][i][lane] = round_to<T>(p * (dw - delta[i]) * a.scale);
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        const float kv = k_s[j][lane + 32 * d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i][d] = fmaf(ds_s[warp][i][j], kv, acc[i][d]);
      }
    }
  }

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    T* row = dqb + ((long long)b * tq + qi) * (H * D) + h * D;
#pragma unroll
    for (int d = 0; d < kDims; ++d) row[lane + 32 * d] = from_float<T>(acc[i][d]);
  }
}

// ---------------------------------------------------------------------------
// dk and dv: a block owns 32 keys of one (batch, head)
// ---------------------------------------------------------------------------
template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_bwd_dkdv(Args a) {
  constexpr int kDims = D / 32;
  extern __shared__ float smem[];
  float(*k_s)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*v_s)[D] = k_s + kBlock;
  float(*qr_s)[D] = v_s + kBlock;   // raw q (for dk)
  float(*dok_s)[D] = qr_s + kTile;  // round(do / keep) (for dv)
  float(*qs_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(dok_s + kTile);
  float(*do_s)[D + 1] = qs_s + kTile;
  float(*g_s)[kRowsPerWarp][kTile] =
      reinterpret_cast<float(*)[kRowsPerWarp][kTile]>(do_s + kTile);
  float(*ds_s)[kRowsPerWarp][kTile] = g_s + kWarps;
  float* lse_s = reinterpret_cast<float*>(ds_s + kWarps);
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int tq = a.tq, tk = a.tk, H = a.num_heads;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * D;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * D;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * D;
  const T* dob = static_cast<const T*>(a.dout) + b * a.do_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  for (int idx = tid; idx < kBlock * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D, kj = k0 + r;
    const bool in = kj < tk;
    k_s[r][c] = in ? to_float(kb[kj * a.k_sr + c]) : 0.f;
    v_s[r][c] = in ? to_float(vb[kj * a.v_sr + c]) : 0.f;
  }
  const int key0 = k0 + warp * kRowsPerWarp;  // the warp's first key
  float bias_k[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
    bias_k[i] = (a.use_bias && key0 + i < tk)
                    ? a.bias[(long long)b * tk + key0 + i]
                    : 0.f;

  float dk[kRowsPerWarp][kDims], dv[kRowsPerWarp][kDims];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int d = 0; d < kDims; ++d) dk[i][d] = dv[i][d] = 0.f;

  // causal: queries before the block's first key see none of its keys
  for (int q0 = a.causal ? k0 : 0; q0 < tq; q0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * D; idx += blockDim.x) {
      const int r = idx / D, c = idx - r * D, qi = q0 + r;
      const bool in = qi < tq;
      const float qv = in ? to_float(qb[qi * a.q_sr + c]) : 0.f;
      const float dov = in ? to_float(dob[qi * a.do_sr + c]) : 0.f;
      qr_s[r][c] = qv;
      qs_s[r][c] = round_to<T>(qv * a.scale);
      do_s[r][c] = dov;
      dok_s[r][c] = round_to<T>(dov * a.inv_keep);
    }
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

    float s[kRowsPerWarp], dg[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dg[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qc = qs_s[lane][c], dc = do_s[lane][c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = fmaf(qc, k_s[warp * kRowsPerWarp + i][c], s[i]);
        dg[i] = fmaf(dc, v_s[warp * kRowsPerWarp + i][c], dg[i]);
      }
    }

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
        dw = keep ? dw * a.inv_keep : 0.f;
      }
      g_s[warp][i][lane] = round_to<T>(g);
      ds_s[warp][i][lane] = round_to<T>(p * (dw - delta_s[lane]) * a.scale);
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        const float dok = dok_s[j][lane + 32 * d];
        const float qr = qr_s[j][lane + 32 * d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          dv[i][d] = fmaf(g_s[warp][i][j], dok, dv[i][d]);
          dk[i][d] = fmaf(ds_s[warp][i][j], qr, dk[i][d]);
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
    const long long off = ((long long)b * tk + kj) * (H * D) + h * D;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      dkb[off + lane + 32 * d] = from_float<T>(dk[i][d]);
      dvb[off + lane + 32 * d] = from_float<T>(dv[i][d]);
    }
  }
}

template <typename T, int D, bool kDropout>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  // dynamic shared memory above 48 KB needs the opt-in, once per kernel
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        mha_bwd_dq<T, D, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(mha_bwd_dkdv<T, D, kDropout>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid_q((a.tq + kBlock - 1) / kBlock, a.num_heads, batch);
  mha_bwd_dq<T, D, kDropout>
      <<<grid_q, kWarps * 32, dq_smem_bytes<D>(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.tk + kBlock - 1) / kBlock, a.num_heads, batch);
  mha_bwd_dkdv<T, D, kDropout>
      <<<grid_k, kWarps * 32, dkdv_smem_bytes<D>(), stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_rate(bool dropout, const Args& a, int batch,
                          cudaStream_t stream) {
  return dropout ? launch<T, D, true>(a, batch, stream)
                 : launch<T, D, false>(a, batch, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 96.  Strides are in
// elements; the last dim of q, k, v, o and dout must be contiguous.  bias
// [B, Tk] float32 (ignored unless use_bias); seed one int64 on the device
// (read only when dropout != 0); lse [B, Tq, H] float32 from the forward.
// dq [B, Tq, H*D], dk and dv [B, Tk, H*D] in the input type and delta
// [B, Tq, H] float32 (workspace) are contiguous outputs.  inv_keep is
// float(1 / (1 - rate)).
extern "C" int mha_bwd(int dtype, int head_dim, const void* q, const void* k,
                       const void* v, const void* bias, const void* seed,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* delta, int batch,
                       int tq, int tk, int num_heads, long long q_sb,
                       long long q_sr, long long k_sb, long long k_sr,
                       long long v_sb, long long v_sr, long long o_sb,
                       long long o_sr, long long do_sb, long long do_sr,
                       float scale, int causal, int use_bias, int dropout,
                       unsigned threshold, float inv_keep, void* stream) {
  Args a{q,  k,  v,  static_cast<const float*>(bias),
         static_cast<const long long*>(seed), o, static_cast<const float*>(lse),
         dout, dq, dk, dv, static_cast<float*>(delta),
         tq, tk, num_heads, q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, o_sb, o_sr,
         do_sb, do_sr, scale, causal, use_bias, threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
  if (dtype == 0 && head_dim == 64)
    return dispatch_rate<float, 64>(drop, a, batch, s);
  if (dtype == 0 && head_dim == 96)
    return dispatch_rate<float, 96>(drop, a, batch, s);
  if (dtype == 1 && head_dim == 64)
    return dispatch_rate<__nv_bfloat16, 64>(drop, a, batch, s);
  if (dtype == 1 && head_dim == 96)
    return dispatch_rate<__nv_bfloat16, 96>(drop, a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mha_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
