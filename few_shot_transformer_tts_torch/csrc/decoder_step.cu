// Fused AR decode step for Hopper (sm_90a): one frame through every decoder
// layer in one cooperative launch.
//
// Replaces the TPU kernel `decoder_frame_step`
// (few_shot_transformer_tts_tpu/ops/pallas_decode.py:346, body `_kernel`).
// Per layer l (x is the fp32 residual stream, [B, C]):
//
//   qkv  = round(LN(x)) . w_qkv[l]                     fp32 accumulation
//   q    = qkv[:, :C] * D^-0.5;  k_f, v_f = qkv[:, C:2C], qkv[:, 2C:]
//   s_t  = sum_d round(round(q_d) * cache_k[t, d])      t < step, per head
//   s_f  = sum_d round(q_d * k_f_d)                     the fresh position
//   w    = softmax over {s_t} and s_f jointly (fp32)
//   ctx  = sum_t round(w_t) cache_v[t] + round(w_f) v_f
//   x   += round(ctx) . w_out[l]
//   qx   = round(LN(x)) . w_q[l] * D^-0.5
//   a_t  = softmax_t(sum_d round(round(qx_d) * mem_k[t, d]) + mem_bias[t])
//   x   += round(sum_t round(a_t) mem_v[t]) . w_xout[l]
//   x   += round(relu(round(LN(x)) . w_ffn1[l])) . w_ffn2[l]
//
// `round` is the rounding to the weights' type (bf16 or the identity in
// fp32), at the TPU kernel's points; LN statistics are fp32 (two-pass, eps
// 1e-6).  Outputs: x_out (x after the last layer, before the final LN),
// align[l, b, t, h] = a_t (fp32), k_new/v_new[l] = k_f, v_f in the cache type.
//
// Bound.  At the flagship shape (L=6, C=768, H=8, FFN 3072, B=8, bf16, memory
// padded to 256) a frame must read 99.1 MB of stacked weights and 37.7 MB of
// memory K/V, plus 0.147 MB of self cache per decoded position: 41 us at
// step 0 and 64 us at step 511 at 3.35 TB/s; ~0.8 GFLOP per frame is
// negligible.  It is a GEMV-shaped, memory-bound kernel.
//
// Design.  The TPU grid runs the layers in order on one core; here one
// cooperative launch covers the whole frame, one block per SM at most (the
// blocks must be co-resident), and `grid.sync()` separates the set-up, the
// eight dependent stages of each layer and the output stage (49 grid-wide
// barriers per frame at six layers), so the host issues one launch per
// frame.
//   * Products (QKV, out-proj, q-proj, cross out-proj, FFN in, FFN out):
//     every weight byte is read once per frame for all B rows.  A work item
//     is 64 weight rows x one column group (32 lanes x one 16-byte vector);
//     each of the block's 8 warps issues the loads of its 8 rows first, and
//     while they are in flight the block stages the item's B input rows (LN
//     applied, from statistics the block computes itself, or ReLU; then
//     rounded) in shared memory.  Each lane keeps B x 8 fp32 sums (B in
//     passes of 8), the warps reduce through shared memory in a fixed
//     order, and the block adds its partial sums into the output with
//     64-bit integer atomics on a fixed-point image of the values (2^-28
//     resolution).  Integer addition does not depend on its order, so the
//     kernel is deterministic: the same inputs give the same bits whatever
//     order the blocks finish in, which fp32 atomics would not.  A LN costs
//     no barrier, and the residual adds are the atomics into the
//     fixed-point residual stream itself.  A partial sum that is not finite
//     or exceeds 2^24 in magnitude (outside what the fixed-point range can
//     add up) raises a flag, and every output of the frame is then NaN.
//     The stage is not inlined: six inlined copies of its unrolled loop
//     made every stage slower.
//   * Attention: one block per (b, h).  Logits with one thread per position
//     (16-byte loads along the head's D values), softmax statistics by block
//     reductions, then the weighted sum of V with threads along D.  Only
//     the valid cache prefix (t < step) is read.
// Scratch (the residual stream, qkv, cross q and FFN hidden in fixed point;
// ctx in fp32; the flag) is memory the wrapper allocates; accumulators are
// zeroed a stage or more before use.  Scalar
// FMA throughout: tensor cores, TMA and a finer split of the attention are
// later work (PERF.md has the stage times that point there).
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsB = 8;     // batch rows per product pass
constexpr int kChunkK = 64;   // weight rows per product work item
constexpr float kEps = 1e-6f;
// Fixed point of the product sums: value = integer * 2^-28.  A partial sum
// is at most 2^24 in magnitude; 48 of them per product, 19 products into
// the residual stream, stay below 2^34 and so within the int64 range.
constexpr float kFixScale = 268435456.f;  // 2^28
constexpr float kFixLimit = 16777216.f;   // 2^24

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

// 16 bytes of a read-only tensor (weights, caches, memory) as fp32 values.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ uint4 load_raw(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f);

template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  unpack<T>(load_raw(p), f);
}

__device__ __forceinline__ long long to_fixed(float x) {
  return __float2ll_rn(x * kFixScale);
}
__device__ __forceinline__ float from_fixed(long long v) {
  return __ll2float_rn(v) * (1.f / kFixScale);
}

// One activation of a product's input: fp32, or a fixed-point sum.
__device__ __forceinline__ float load_act(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_act(const long long* p) {
  return from_fixed(__ldcg(p));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide sum / max; red holds kWarps floats.  Every thread gets the
// result.  The first barrier keeps a previous call's readers from racing.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  return m;
}

template <typename T>
struct Params {
  const float* x;                 // [B, C] fp32
  const float* lns;               // [L, 6, C] fp32
  const T* w_qkv;                 // [L, C, 3C]
  const T* w_out;                 // [L, C, C]
  const T* w_q;                   // [L, C, C]
  const T* w_xout;                // [L, C, C]
  const T* w_ffn1;                // [L, C, F]
  const T* w_ffn2;                // [L, F, C]
  const T* cache_k;               // [L, B, Tcap, C]
  const T* cache_v;
  const T* mem_k;                 // [L, B, Tm, C]
  const T* mem_v;
  const float* mem_bias;          // [B, Tm] fp32
  float* x_out;                   // [B, C] fp32
  float* align;                   // [L, B, Tm, H] fp32
  T* k_new;                       // [L, B, C]
  T* v_new;
  long long* xs;                  // scratch [B, C]: the residual stream
  long long* qkv;                 // scratch [B, 3C]
  long long* qx;                  // scratch [B, C]
  long long* hid;                 // scratch [B, F]
  float* ctx;                     // scratch [B, C] fp32
  int* bad;                       // scratch: a partial sum left the range
  unsigned long long* trace;      // [8L + 2] stage timeline, or null
  int step, n_layers, batch, t_cap, t_mem, c, f, heads, head_dim;
  float scale;
};

// Block 0 stamps the global timer (ns) as it passes stage boundary i.
template <typename T>
__device__ __forceinline__ void mark(const Params<T>& p, int i) {
  if (p.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.trace[i] = t;
  }
}

enum Source { kLayerNorm, kPlain, kRelu };

// out[B, N] += round(src(a))[B, K] . w[K, N] (out in fixed point), split
// over the grid in items of kChunkK rows x one column group; the block's
// warps split the rows.
// Each warp issues all its weight loads of the item first, so they are in
// flight while the activations are staged: with LN, the pass's rows of x
// are read into shared memory at once and their statistics (fp32,
// two-pass) computed there, one warp per row.
template <typename T, int kSource, typename A>
__device__ __noinline__ void product(const A* a, int k_dim,
                                     const float* gamma, const float* beta,
                                     const T* __restrict__ w, int n_dim,
                                     long long* out, int* bad, int batch,
                                     float* smem) {
  constexpr int V = Vec<T>::N;
  constexpr int kCols = 32 * V;
  constexpr int kRowsPerWarp = kChunkK / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_groups = (n_dim + kCols - 1) / kCols;
  const int n_items = n_groups * ((k_dim + kChunkK - 1) / kChunkK);
  float* a_s = smem;                           // [kRowsB][kChunkK]
  float* red = a_s + kRowsB * kChunkK;         // [kWarps][kRowsB][kCols]
  float* stats = red + kWarps * kRowsB * kCols;  // mean, rstd [kRowsB]
  float* x_s = stats + 2 * kRowsB;             // [kRowsB][k_dim] (LN only)
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int group = item % n_groups;
    const int k0 = (item / n_groups) * kChunkK;
    const int kn = min(kChunkK, k_dim - k0);
    const int col = group * kCols + lane * V;
    const bool col_ok = col < n_dim;  // n_dim % V == 0
    uint4 wr[kRowsPerWarp];           // rows warp, warp + kWarps, ...
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int kr = warp + u * kWarps;
      wr[u] = col_ok && kr < kn
                  ? load_raw(w + (long long)(k0 + kr) * n_dim + col)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int b0 = 0; b0 < batch; b0 += kRowsB) {
      const int nb = min(kRowsB, batch - b0);
      __syncthreads();  // the previous pass's shared memory is consumed
      if (kSource == kLayerNorm) {
        const A* rows = a + (long long)b0 * k_dim;
#pragma unroll 8
        for (int i = threadIdx.x; i < nb * k_dim; i += kThreads)
          x_s[i] = load_act(rows + i);
        __syncthreads();
        if (warp < nb) {
          const float* row = x_s + warp * k_dim;
          float sum = 0.f;
          for (int i = lane; i < k_dim; i += 32) sum += row[i];
          const float m = warp_sum(sum) / k_dim;
          float var = 0.f;
          for (int i = lane; i < k_dim; i += 32) {
            const float d = row[i] - m;
            var += d * d;
          }
          var = warp_sum(var) / k_dim;
          if (lane == 0) {
            stats[warp] = m;
            stats[kRowsB + warp] = 1.f / sqrtf(var + kEps);
          }
        }
        __syncthreads();
      }
      static_assert(kRowsB * kChunkK % kThreads == 0, "a_s fill");
#pragma unroll
      for (int j = 0; j < kRowsB * kChunkK / kThreads; ++j) {
        const int i = threadIdx.x + j * kThreads;
        const int r = i / kChunkK, kk = i - r * kChunkK;
        float v = 0.f;
        if (r < nb && kk < kn) {
          const int k = k0 + kk;
          if (kSource == kLayerNorm) {
            v = (x_s[r * k_dim + k] - stats[r]) * stats[kRowsB + r] *
                    gamma[k] + beta[k];
          } else {
            v = load_act(a + (long long)(b0 + r) * k_dim + k);
            if (kSource == kRelu) v = fmaxf(v, 0.f);
          }
          v = round_to<T>(v);
        }
        a_s[i] = v;
      }
      __syncthreads();

      float acc[kRowsB][V];
#pragma unroll
      for (int r = 0; r < kRowsB; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        float wv[V];
        unpack<T>(wr[u], wv);
        const int kr = warp + u * kWarps;  // wr is 0 past kn; a_s is 0 too
#pragma unroll
        for (int r = 0; r < kRowsB; ++r) {
          const float av = a_s[r * kChunkK + kr];
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(av, wv[j], acc[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsB; ++r) {
        float4* dst = reinterpret_cast<float4*>(
            red + (warp * kRowsB + r) * kCols + lane * V);
#pragma unroll
        for (int j = 0; j < V; j += 4)
          dst[j / 4] = make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2],
                                   acc[r][j + 3]);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kRowsB * kCols; i += kThreads) {
        const int r = i / kCols, cc = i - r * kCols;
        const int n = group * kCols + cc;
        if (r < nb && n < n_dim) {
          float s = 0.f;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp)
            s += red[(wp * kRowsB + r) * kCols + cc];
          if (!(fabsf(s) <= kFixLimit)) *bad = 1;  // also NaN
          atomicAdd(reinterpret_cast<unsigned long long*>(out) +
                        (long long)(b0 + r) * n_dim + n,
                    static_cast<unsigned long long>(to_fixed(s)));
        }
      }
    }
  }
}

// sum_d round(round(q_d) * row_d) over one head's D values (16-byte loads).
template <typename T>
__device__ __forceinline__ float head_logit(const T* __restrict__ row,
                                            const float* qr, int head_dim) {
  constexpr int V = Vec<T>::N;
  float s = 0.f;
#pragma unroll 12
  for (int d0 = 0; d0 < head_dim; d0 += V) {
    float kv[V];
    load_vec(row + d0, kv);
#pragma unroll
    for (int j = 0; j < V; ++j) s += round_to<T>(qr[d0 + j] * kv[j]);
  }
  return s;
}

// ctx_d = sum_{t < n} round(w_t) v[t, d] for one head, into out[0..D);
// threads split as (position group, 16-byte vector of the head).
template <typename T>
__device__ void head_context(const T* __restrict__ v, long long row_stride,
                             const float* wts, int n, int head_dim,
                             float* red, float* out) {
  constexpr int V = Vec<T>::N;
  const int nvec = head_dim / V;
  const int groups = kThreads / nvec;
  const int g = threadIdx.x / nvec, iv = threadIdx.x - g * nvec;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (g < groups) {
#pragma unroll 8
    for (int t = g; t < n; t += groups) {
      float vv[V];
      load_vec(v + t * row_stride + iv * V, vv);
      const float wt = round_to<T>(wts[t]);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(wt, vv[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) red[g * head_dim + iv * V + j] = acc[j];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < head_dim; d += kThreads) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += red[gg * head_dim + d];
    out[d] = s;
  }
  __syncthreads();
}

// Attention smem: q (fp32), q rounded, k_f, v_f, ctx [D each], the logits of
// every position, the context partials [kThreads * V], block reductions.
template <typename T>
__device__ void self_attention(const Params<T>& p, int l, float* smem) {
  const int D = p.head_dim, C = p.c, H = p.heads, step = p.step;
  float* qf = smem;
  float* qr = qf + D;
  float* kf = qr + D;
  float* vf = kf + D;
  float* cx = vf + D;
  float* red = cx + D;                    // [kWarps]
  float* part = red + kWarps;             // [kThreads * V]
  float* lg = part + kThreads * Vec<T>::N;  // [max(Tcap, Tm)]
  for (int item = blockIdx.x; item < p.batch * H; item += gridDim.x) {
    const int b = item / H, h = item - (item / H) * H;
    __syncthreads();
    const long long* row = p.qkv + (long long)b * 3 * C + h * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float q = load_act(row + d) * p.scale;
      const float k = load_act(row + C + d);
      const float v = load_act(row + 2 * C + d);
      qf[d] = q;
      qr[d] = round_to<T>(q);
      kf[d] = k;
      vf[d] = v;
      const long long o = ((long long)l * p.batch + b) * C + h * D + d;
      p.k_new[o] = from_float<T>(k);
      p.v_new[o] = from_float<T>(v);
    }
    __syncthreads();
    float fresh = 0.f;  // every thread sums the fresh logit itself
    for (int d = 0; d < D; ++d) fresh += round_to<T>(qf[d] * kf[d]);

    const long long base = ((long long)l * p.batch + b) * p.t_cap * C + h * D;
    const T* ck = p.cache_k + base;
    float m = -INFINITY;
    for (int t = threadIdx.x; t < step; t += kThreads) {
      const float s = head_logit(ck + (long long)t * C, qr, D);
      lg[t] = s;
      m = fmaxf(m, s);
    }
    m = fmaxf(block_max(m, red), fresh);
    float sum = 0.f;
    for (int t = threadIdx.x; t < step; t += kThreads) {
      const float e = expf(lg[t] - m);
      lg[t] = e;
      sum += e;
    }
    const float pf = expf(fresh - m);
    const float den = block_sum(sum, red) + pf;
    for (int t = threadIdx.x; t < step; t += kThreads) lg[t] = lg[t] / den;
    __syncthreads();
    head_context(p.cache_v + base, C, lg, step, D, part, cx);
    const float wf = round_to<T>(pf / den);
    for (int d = threadIdx.x; d < D; d += kThreads)
      p.ctx[(long long)b * C + h * D + d] = cx[d] + wf * vf[d];
  }
}

template <typename T>
__device__ void cross_attention(const Params<T>& p, int l, float* smem) {
  const int D = p.head_dim, C = p.c, H = p.heads, tm = p.t_mem;
  float* qr = smem;
  float* cx = qr + D;
  float* red = cx + D;
  float* part = red + kWarps;
  float* lg = part + kThreads * Vec<T>::N;
  for (int item = blockIdx.x; item < p.batch * H; item += gridDim.x) {
    const int b = item / H, h = item - (item / H) * H;
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += kThreads)
      qr[d] = round_to<T>(load_act(p.qx + (long long)b * C + h * D + d) *
                          p.scale);
    __syncthreads();
    const long long base = ((long long)l * p.batch + b) * tm * C + h * D;
    const float* bias = p.mem_bias + (long long)b * tm;
    float m = -INFINITY;
    for (int t = threadIdx.x; t < tm; t += kThreads) {
      const float s = head_logit(p.mem_k + base + (long long)t * C, qr, D) +
                      bias[t];
      lg[t] = s;
      m = fmaxf(m, s);
    }
    m = block_max(m, red);
    float sum = 0.f;
    for (int t = threadIdx.x; t < tm; t += kThreads) {
      const float e = expf(lg[t] - m);
      lg[t] = e;
      sum += e;
    }
    const float den = block_sum(sum, red);
    float* al = p.align + ((long long)l * p.batch + b) * tm * H + h;
    for (int t = threadIdx.x; t < tm; t += kThreads) {
      const float wt = lg[t] / den;
      lg[t] = wt;
      al[(long long)t * H] = wt;
    }
    __syncthreads();
    head_context(p.mem_v + base, C, lg, tm, D, part, cx);
    for (int d = threadIdx.x; d < D; d += kThreads)
      p.ctx[(long long)b * C + h * D + d] = cx[d];
  }
}

__device__ void zero(long long* p, long long n) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    p[i] = 0;
}

template <typename T>
__host__ __device__ __forceinline__ int product_items(int k_dim, int n_dim) {
  constexpr int kCols = 32 * Vec<T>::N;
  return ((n_dim + kCols - 1) / kCols) * ((k_dim + kChunkK - 1) / kChunkK);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decoder_step_kernel(const Params<T> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int B = p.batch, C = p.c, F = p.f;
  const long long bc = (long long)B * C, cc = (long long)C * C;
  const long long cf = (long long)C * F;

  // stage 0: the residual stream from x; zero the accumulators and the flag
  // (an x out of range sets the flag after the barrier that orders the reset)
  mark(p, 0);
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.bad = 0;
  bool x_bad = false;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < bc;
       i += (long long)gridDim.x * kThreads) {
    const float v = p.x[i];
    x_bad |= !(fabsf(v) <= kFixLimit);
    p.xs[i] = to_fixed(v);
  }
  zero(p.qkv, 3 * bc);
  zero(p.qx, bc);
  zero(p.hid, (long long)B * F);
  grid.sync();
  if (x_bad) *p.bad = 1;
  mark(p, 1);

  for (int l = 0; l < p.n_layers; ++l) {
    const float* ln = p.lns + (long long)l * 6 * C;
    const long long wcc = l * cc;
    const int m0 = 2 + 8 * l;
    // 1: qkv = LN1(x) . w_qkv
    product<T, kLayerNorm>(p.xs, C, ln, ln + C, p.w_qkv + 3 * wcc,
                           3 * C, p.qkv, p.bad, B, smem);
    grid.sync();
    mark(p, m0);
    // 2: causal self-attention -> ctx, k_new, v_new; zero hid
    self_attention(p, l, smem);
    zero(p.hid, (long long)B * F);
    grid.sync();
    mark(p, m0 + 1);
    // 3: x += ctx . w_out; zero qkv
    product<T, kPlain>(p.ctx, C, nullptr, nullptr, p.w_out + wcc, C,
                       p.xs, p.bad, B, smem);
    zero(p.qkv, 3 * bc);
    grid.sync();
    mark(p, m0 + 2);
    // 4: qx = LN2(x) . w_q
    product<T, kLayerNorm>(p.xs, C, ln + 2 * C, ln + 3 * C,
                           p.w_q + wcc, C, p.qx, p.bad, B, smem);
    grid.sync();
    mark(p, m0 + 3);
    // 5: cross-attention -> ctx, align
    cross_attention(p, l, smem);
    grid.sync();
    mark(p, m0 + 4);
    // 6: x += ctx . w_xout; zero qx
    product<T, kPlain>(p.ctx, C, nullptr, nullptr, p.w_xout + wcc, C,
                       p.xs, p.bad, B, smem);
    zero(p.qx, bc);
    grid.sync();
    mark(p, m0 + 5);
    // 7: hid = LN3(x) . w_ffn1
    product<T, kLayerNorm>(p.xs, C, ln + 4 * C, ln + 5 * C,
                           p.w_ffn1 + l * cf, F, p.hid, p.bad, B, smem);
    grid.sync();
    mark(p, m0 + 6);
    // 8: x += relu(hid) . w_ffn2
    product<T, kRelu>(p.hid, F, nullptr, nullptr, p.w_ffn2 + l * cf, C,
                      p.xs, p.bad, B, smem);
    grid.sync();
    mark(p, m0 + 7);
  }

  // x_out from the residual stream; NaN everywhere if a sum left the range
  const long long tid = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const bool bad = __ldcg(p.bad) != 0;
  for (long long i = tid; i < bc; i += stride)
    p.x_out[i] = bad ? NAN : from_fixed(__ldcg(p.xs + i));
  if (bad) {
    const long long n_align =
        (long long)p.n_layers * B * p.t_mem * p.heads;
    for (long long i = tid; i < n_align; i += stride) p.align[i] = NAN;
    for (long long i = tid; i < p.n_layers * bc; i += stride) {
      p.k_new[i] = from_float<T>(NAN);
      p.v_new[i] = from_float<T>(NAN);
    }
  }
}

// Dynamic shared memory in floats: the larger of the product stage (with
// the LN rows of width c) and the attention stages.
template <typename T>
size_t smem_floats(int c, int head_dim, int max_t) {
  constexpr int V = Vec<T>::N;
  const size_t prod = kRowsB * kChunkK + (size_t)kWarps * kRowsB * 32 * V +
                      2 * kRowsB + (size_t)kRowsB * c;
  const size_t attn = 5 * (size_t)head_dim + kWarps + kThreads * V + max_t;
  return prod > attn ? prod : attn;
}

// The device's SM count for a kernel's shared memory size, after the
// opt-in to that size and a check that one block per SM fits.
struct LaunchConfig {
  int dev = -1;
  size_t smem = 0;
  int sms = 0;
};

template <typename T>
cudaError_t configure(int dev, size_t smem, LaunchConfig* cfg) {
  auto kernel = decoder_step_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cfg->dev = dev;
  cfg->smem = smem;
  cfg->sms = sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  const size_t smem =
      smem_floats<T>(p.c, p.head_dim, std::max(p.t_cap, p.t_mem)) *
      sizeof(float);
  // A synthesis launches one device and size every frame: the attribute
  // and occupancy calls run when either changes.
  static std::mutex mu;
  static LaunchConfig cached;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  LaunchConfig cfg;
  {
    std::lock_guard<std::mutex> lock(mu);
    cfg = cached;
  }
  if (cfg.dev != dev || cfg.smem != smem) {
    if ((e = configure<T>(dev, smem, &cfg)) != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(mu);
    cached = cfg;
  }
  const int sms = cfg.sms;
  auto kernel = decoder_step_kernel<T>;
  // no stage has more work items than this; fewer blocks sync faster
  const int items = std::max({p.batch * p.heads,
                              product_items<T>(p.c, 3 * p.c),
                              product_items<T>(p.c, p.f),
                              product_items<T>(p.f, p.c)});
  const int grid = std::max(1, std::min(sms, items));
  void* args[] = {const_cast<Params<T>*>(&p)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, int step, const void* lns, const void* const* w,
        const void* cache_k, const void* cache_v, const void* mem_k,
        const void* mem_v, const void* mem_bias, void* x_out, void* align,
        void* k_new, void* v_new, void* scratch, void* trace, int n_layers,
        int batch, int t_cap, int t_mem, int channels, int ffn,
        int num_heads, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  if (num_heads < 1 || channels % num_heads || (channels / num_heads) % V ||
      channels / num_heads > 256 || ffn % V || batch < 1 ||
      n_layers < 1 || step < 0 || step >= t_cap ||
      t_mem < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> p;
  p.x = static_cast<const float*>(x);
  p.lns = static_cast<const float*>(lns);
  p.w_qkv = static_cast<const T*>(w[0]);
  p.w_out = static_cast<const T*>(w[1]);
  p.w_q = static_cast<const T*>(w[2]);
  p.w_xout = static_cast<const T*>(w[3]);
  p.w_ffn1 = static_cast<const T*>(w[4]);
  p.w_ffn2 = static_cast<const T*>(w[5]);
  p.cache_k = static_cast<const T*>(cache_k);
  p.cache_v = static_cast<const T*>(cache_v);
  p.mem_k = static_cast<const T*>(mem_k);
  p.mem_v = static_cast<const T*>(mem_v);
  p.mem_bias = static_cast<const float*>(mem_bias);
  p.x_out = static_cast<float*>(x_out);
  p.align = static_cast<float*>(align);
  p.k_new = static_cast<T*>(k_new);
  p.v_new = static_cast<T*>(v_new);
  const long long bc = (long long)batch * channels;
  p.xs = static_cast<long long*>(scratch);
  p.qkv = p.xs + bc;
  p.qx = p.qkv + 3 * bc;
  p.hid = p.qx + bc;
  p.ctx = reinterpret_cast<float*>(p.hid + (long long)batch * ffn);
  p.bad = reinterpret_cast<int*>(p.ctx + bc);
  p.trace = static_cast<unsigned long long*>(trace);
  p.step = step;
  p.n_layers = n_layers;
  p.batch = batch;
  p.t_cap = t_cap;
  p.t_mem = t_mem;
  p.c = channels;
  p.f = ffn;
  p.heads = num_heads;
  p.head_dim = channels / num_heads;
  p.scale = static_cast<float>(pow(static_cast<double>(p.head_dim), -0.5));
  return static_cast<int>(launch<T>(p, stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (weights, caches, memory, k_new/v_new).
// x [B, C], lns [L, 6, C], mem_bias [B, Tm], x_out [B, C] and align [L, B,
// Tm, H] are float32; scratch holds B * (5C + F) int64, then B * C float32
// and one int32 (decoder_step_scratch_bytes); every tensor is contiguous and
// 16-byte aligned.  w_qkv [L, C, 3C], w_out / w_q / w_xout [L, C, C], w_ffn1
// [L, C, F], w_ffn2 [L, F, C]; caches [L, B, Tcap, C] hold positions < step;
// memory [L, B, Tm, C].  Takes head dims that are a multiple of 16 bytes, up
// to 256; 0 <= step < Tcap.  trace, when not null, gets
// 8L + 2 global-timer stamps (ns): the start, then the end of stage 0 and of
// each layer's eight stages as block 0 sees them.
extern "C" int decoder_step(int dtype, const void* x, int step,
                            const void* lns, const void* w_qkv,
                            const void* w_out, const void* w_q,
                            const void* w_xout, const void* w_ffn1,
                            const void* w_ffn2, const void* cache_k,
                            const void* cache_v, const void* mem_k,
                            const void* mem_v, const void* mem_bias,
                            void* x_out, void* align, void* k_new,
                            void* v_new, void* scratch, void* trace,
                            int n_layers,
                            int batch, int t_cap, int t_mem, int channels,
                            int ffn, int num_heads, void* stream) {
  const void* w[6] = {w_qkv, w_out, w_q, w_xout, w_ffn1, w_ffn2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODER_STEP_ARGS                                                   \
  x, step, lns, w, cache_k, cache_v, mem_k, mem_v, mem_bias, x_out, align, \
      k_new, v_new, scratch, trace, n_layers, batch, t_cap, t_mem, channels, \
      ffn, num_heads, s
  if (dtype == 0) return run<float>(DECODER_STEP_ARGS);
  if (dtype == 1) return run<__nv_bfloat16>(DECODER_STEP_ARGS);
#undef DECODER_STEP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" long long decoder_step_scratch_bytes(int batch, int channels,
                                                int ffn) {
  const long long b = batch;
  return b * (5LL * channels + ffn) * 8 + b * channels * 4 + 4;
}

extern "C" const char* decoder_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
