// LayerNorm backward for Hopper (sm_90a): dx, dgamma, dbeta in one pass
// over x and dy.
//
// Replaces the TPU kernel `fused_layer_norm`'s backward
// (few_shot_transformer_tts_tpu/ops/fused_layernorm.py, `_bwd_rule` and its
// body `_bwd_kernel`).  Per row of x [N, C] (fp32 statistics):
//
//   mean = E[x],  var = max(E[x^2] - mean^2, 0),  rstd = rsqrt(var + eps)
//   xhat = (x - mean) * rstd,  g = dy * gamma
//   dx   = rstd * (g - xhat * mean(g * xhat) - mean(g))    (x's type)
//   dgamma = sum_rows dy * xhat,  dbeta = sum_rows dy      (fp32, [C])
//
// Design.  The TPU kernel walks the row tiles in order on one core and keeps
// dgamma/dbeta in its revisited output block; Hopper blocks run in parallel,
// so the column sums take two stages with no atomics (deterministic):
//   * ln_bwd_rows: about two blocks per SM, each owning a contiguous range of
//     rows.  A warp takes one row at a time and holds it in registers (lane j
//     owns columns j, j+32, ...), so x and dy are read from device memory
//     once; the row statistics are warp shuffles.  Each lane sums its
//     columns' dgamma/dbeta terms over the warp's rows, the 8 warps' sums
//     meet in shared memory in a fixed order, and the block writes one
//     partial row [2, C] to the workspace.
//   * ln_bwd_reduce: one block per 32 columns sums the partial rows, 8 row
//     strides at a time, then the 8 strides in a fixed order.
// Rows need not be a multiple of anything (B*T for any batch).
//
// Bound.  Reads x and dy and writes dx (plus gamma and the [C] results): at
// the decoder shape N=7168, C=768, bf16 that is 33 MB, 9.9 us at 3.35 TB/s;
// about 10 flops per element is far below the compute bound.  The partial
// rows add 2 x blocks x C x 4 bytes (1.6 MB at 264 blocks).
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches both kernels on the given stream, allocates nothing (the
// workspace comes from the caller) and returns the first launch error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// kCols: columns per lane the instantiation holds (C <= 32 * kCols).
template <typename T, int kCols>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_rows(const T* __restrict__ x, const float* __restrict__ gamma,
            const T* __restrict__ dy, T* __restrict__ dx,
            float* __restrict__ partial, int rows, int cols,
            int rows_per_block, float eps) {
  extern __shared__ float red[];  // [kWarps][cols]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);

  float gam[kCols], acc_g[kCols], acc_b[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = lane + 32 * j;
    gam[j] = c < cols ? gamma[c] : 0.f;
    acc_g[j] = acc_b[j] = 0.f;
  }

  for (int r = r0 + warp; r < r1; r += kWarps) {
    const T* xr = x + (long long)r * cols;
    const T* dyr = dy + (long long)r * cols;
    float xv[kCols], dv[kCols];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      xv[j] = c < cols ? to_float(xr[c]) : 0.f;
      dv[j] = c < cols ? to_float(dyr[c]) : 0.f;
      s += xv[j];
      s2 += xv[j] * xv[j];
    }
    const float mean = warp_sum(s) / static_cast<float>(cols);
    const float mean2 = warp_sum(s2) / static_cast<float>(cols);
    const float rstd = rsqrtf(fmaxf(mean2 - mean * mean, 0.f) + eps);
    float sgx = 0.f, sg = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float xhat = (xv[j] - mean) * rstd;  // g is 0 beyond cols
      const float g = dv[j] * gam[j];
      sgx += g * xhat;
      sg += g;
    }
    const float s1 = warp_sum(sgx) / static_cast<float>(cols);
    const float s0 = warp_sum(sg) / static_cast<float>(cols);
    T* dxr = dx + (long long)r * cols;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      if (c >= cols) continue;
      const float xhat = (xv[j] - mean) * rstd;
      const float g = dv[j] * gam[j];
      dxr[c] = from_float<T>(rstd * (g - xhat * s1 - s0));
      acc_g[j] += dv[j] * xhat;
      acc_b[j] += dv[j];
    }
  }

  // the block's partial row: warps' sums in a fixed order
  float* out = partial + (long long)blockIdx.x * 2 * cols;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      if (c < cols) red[warp * cols + c] = pass == 0 ? acc_g[j] : acc_b[j];
    }
    __syncthreads();
    for (int c = tid; c < cols; c += blockDim.x) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += red[w * cols + c];
      out[pass * cols + c] = t;
    }
  }
}

// partial [parts, 2, cols] -> dgamma [cols], dbeta [cols]; block (32, 8)
__global__ void __launch_bounds__(256)
ln_bwd_reduce(const float* __restrict__ partial, float* __restrict__ dgamma,
              float* __restrict__ dbeta, int parts, int cols) {
  __shared__ float red[2][8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float g = 0.f, bsum = 0.f;
  if (c < cols) {
    for (int p = ty; p < parts; p += 8) {
      g += partial[((long long)p * 2) * cols + c];
      bsum += partial[((long long)p * 2 + 1) * cols + c];
    }
  }
  red[0][ty][tx] = g;
  red[1][ty][tx] = bsum;
  __syncthreads();
  if (ty == 0 && c < cols) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      tg += red[0][w][tx];
      tb += red[1][w][tx];
    }
    dgamma[c] = tg;
    dbeta[c] = tb;
  }
}

template <typename T, int kCols>
cudaError_t launch_rows(const void* x, const void* gamma, const void* dy,
                        void* dx, void* partial, int rows, int cols,
                        int rows_per_block, int blocks, float eps,
                        cudaStream_t stream) {
  const int smem = kWarps * cols * 4;  // at most 32 KB (cols <= 1024)
  ln_bwd_rows<T, kCols><<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, cols, rows_per_block, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cols(const void* x, const void* gamma, const void* dy,
                          void* dx, void* partial, int rows, int cols,
                          int rows_per_block, int blocks, float eps,
                          cudaStream_t s) {
  const int per_lane = (cols + 31) / 32;
#define LN_ROWS(K)                                                        \
  if (per_lane <= K)                                                      \
    return launch_rows<T, K>(x, gamma, dy, dx, partial, rows, cols,       \
                             rows_per_block, blocks, eps, s);
  LN_ROWS(2)
  LN_ROWS(4)
  LN_ROWS(8)
  LN_ROWS(16)
  LN_ROWS(24)
  LN_ROWS(32)
#undef LN_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx).  x, dy, dx [rows, cols]
// contiguous; gamma, dgamma, dbeta [cols] float32; partial a float32
// workspace of [blocks, 2, cols]; block i owns rows
// [i * rows_per_block, (i + 1) * rows_per_block).  cols <= 1024.
extern "C" int ln_bwd(int dtype, const void* x, const void* gamma,
                      const void* dy, void* dx, void* dgamma, void* dbeta,
                      void* partial, int rows, int cols, int rows_per_block,
                      int blocks, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols < 1 || cols > 1024 || rows < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      dtype == 0 ? dispatch_cols<float>(x, gamma, dy, dx, partial, rows, cols,
                                        rows_per_block, blocks, eps, s)
      : dtype == 1
          ? dispatch_cols<__nv_bfloat16>(x, gamma, dy, dx, partial, rows,
                                         cols, rows_per_block, blocks, eps, s)
          : cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce<<<(cols + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), blocks, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ln_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
