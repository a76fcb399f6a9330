// One Adam step over one parameter tensor for Hopper (sm_90a), in place.
//
// Replaces the TPU kernel `fused_adam_step`
// (few_shot_transformer_tts_tpu/ops/fused_adam.py, `_adam_leaf_pallas` and
// its body `_adam_kernel`).  Per element, with the bias corrections folded
// into a = lr / (1 - b1^t) and r = (1 - b2^t)^(-1/2) by the caller:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   p' = p - a m' / (r sqrt(v') + eps)
//
// Every product, sum, quotient and square root is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nvcc would otherwise
// contract a*b + c into one FMA), so the result has the bits of the plain
// version's tensor ops, one rounding per operation.
//
// Design.  The TPU kernel streams ~1 MB row blocks through VMEM.  Here a
// grid-stride loop gives each thread 16-byte vectors (four elements) of p,
// g, m and v at a time: four streams read, three written, in place (each
// element is read and written by the same thread).  A scalar tail covers a
// length that is not a multiple of four.
//
// Bound.  28 bytes per element and 13 flops: bytes bound.  The 37 kernel
// leaves of the flagship model hold 61.7M elements, 1.73 GB a step, 0.52 ms
// at 3.35 TB/s.
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches on the given stream, allocates nothing and returns the launch
// error.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Coef {
  float a, r, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Coef& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fmul_rn(c.r, __fsqrt_rn(v)), c.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.a, m), denom));
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, long long n,
            Coef c) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * kThreads;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += stride) {
    float4 pv = p4[i], mv = m4[i], vv = v4[i];
    const float4 gv = g4[i];
    update(pv.x, gv.x, mv.x, vv.x, c);
    update(pv.y, gv.y, mv.y, vv.y, c);
    update(pv.z, gv.z, mv.z, vv.z, c);
    update(pv.w, gv.w, mv.w, vv.w, c);
    p4[i] = pv;
    m4[i] = mv;
    v4[i] = vv;
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long i = 4 * n4 + threadIdx.x;
    update(p[i], g[i], m[i], v[i], c);
  }
}

}  // namespace

// p, g, m, v: n contiguous float32 each on the device, 16-byte aligned;
// p, m and v are updated in place.  a = lr / (1 - b1^t), r = (1 - b2^t)^-0.5;
// omb1 = 1 - b1 and omb2 = 1 - b2 as the caller rounds them.
extern "C" int adam_step(void* p, const void* g, void* m, void* v,
                         long long n, float a, float r, float b1, float omb1,
                         float b2, float omb2, float eps, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1
                                      : want > kMaxBlocks ? kMaxBlocks
                                                          : want);
  adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n,
      Coef{a, r, b1, omb1, b2, omb2, eps});
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adam_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
