// One Adam step over a list of parameter tensors for Hopper (sm_90a), in
// place, in one launch.
//
// Replaces the TPU kernel `fused_adam_step`
// (few_shot_transformer_tts_tpu/ops/fused_adam.py, `_adam_leaf_pallas` and
// its body `_adam_kernel`), which the JAX package maps over the leaves of a
// tree.  Per element, with the bias corrections folded into
// a = lr / (1 - b1^t) and r = (1 - b2^t)^(-1/2) by the caller:
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
// Design.  The TPU kernel streams ~1 MB row blocks of one leaf through
// VMEM.  Here one launch covers a table of up to kMaxLeaves leaves, passed
// as a kernel parameter: each leaf's p, g, m, v pointers and length, and a
// prefix of chunk counts.  The leaves are cut into chunks of kChunk
// elements, numbered across leaves, and a fixed grid of a few blocks per
// SM walks them with a stride (a block finds its leaf by moving forward
// through the prefix, since its chunks only increase), so no block waits on
// a small leaf's ramp or tail.  A thread loads kVec float4 of each of p, g,
// m and v (16 loads in flight) before the math, with streaming loads and
// stores (__ldcs / __stcs: nothing is read twice), and writes p, m, v back
// in place.  A leaf whose length is not a multiple of four ends in a scalar
// tail.  A list longer than the table is split into launches of
// kMaxLeaves leaves each (the flagship model's 37 kernel leaves take one).
//
// Bound.  28 bytes per element and 13 flops: bytes bound.  The 37 kernel
// leaves of the flagship model hold 61.7M elements, 1.73 GB a step, 0.52 ms
// at 3.35 TB/s.
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches on the given stream, allocates nothing and returns the first
// launch error.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                          // float4 per stream in flight
constexpr int kChunk = kThreads * kVec * 4;      // elements per chunk
constexpr int kBlocksPerSm = 4;
constexpr int kMaxLeaves = 64;                   // a table: 2.8 KB of params

struct Coef {
  float a, r, b1, omb1, b2, omb2, eps;
};

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int chunk_end[kMaxLeaves];   // chunks of leaves 0..i
  int n_leaves;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Coef& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fmul_rn(c.r, __fsqrt_rn(v)), c.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(c.a, m), denom));
}

__device__ __forceinline__ void update4(float4& p, float4 g, float4& m,
                                        float4& v, const Coef& c) {
  update(p.x, g.x, m.x, v.x, c);
  update(p.y, g.y, m.y, v.y, c);
  update(p.z, g.z, m.z, v.z, c);
  update(p.w, g.w, m.w, v.w, c);
}

__global__ void __launch_bounds__(kThreads)
adam_leaves_kernel(const __grid_constant__ Table tab, Coef c) {
  const int n_chunks = tab.chunk_end[tab.n_leaves - 1];
  int li = 0;
  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    while (ch >= tab.chunk_end[li]) ++li;
    const Leaf& L = tab.leaf[li];
    const long long base =
        static_cast<long long>(ch - (li ? tab.chunk_end[li - 1] : 0)) *
        kChunk;
    const long long n4 = L.n / 4;
    float4* p4 = reinterpret_cast<float4*>(L.p);
    const float4* g4 = reinterpret_cast<const float4*>(L.g);
    float4* m4 = reinterpret_cast<float4*>(L.m);
    float4* v4 = reinterpret_cast<float4*>(L.v);
    // float4 i = base / 4 + threadIdx.x + u * kThreads: each load of the
    // warp covers 512 consecutive bytes
    const long long i0 = base / 4 + threadIdx.x;
    float4 pv[kVec], gv[kVec], mv[kVec], vv[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < n4) {
        pv[u] = __ldcs(p4 + i);
        gv[u] = __ldcs(g4 + i);
        mv[u] = __ldcs(m4 + i);
        vv[u] = __ldcs(v4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long i = i0 + u * kThreads;
      if (i < n4) {
        update4(pv[u], gv[u], mv[u], vv[u], c);
        __stcs(p4 + i, pv[u]);
        __stcs(m4 + i, mv[u]);
        __stcs(v4 + i, vv[u]);
      }
    }
    // the leaf's last chunk takes the elements past its last float4
    const long long tail = 4 * n4 + threadIdx.x;
    if (tail < L.n && base + kChunk >= L.n)
      update(L.p[tail], L.g[tail], L.m[tail], L.v[tail], c);
  }
}

}  // namespace

// ptrs: n_leaves x (p, g, m, v) device pointers, each 16-byte aligned;
// lengths: n_leaves element counts, each >= 1; p, m and v are updated in
// place.  a = lr / (1 - b1^t), r = (1 - b2^t)^-0.5; omb1 = 1 - b1 and
// omb2 = 1 - b2 as the caller rounds them.  One launch per kMaxLeaves
// leaves.  Returns the number of launches made, or minus the CUDA error.
extern "C" int adam_leaves(const void* const* ptrs, const long long* lengths,
                           int n_leaves, float a, float r, float b1,
                           float omb1, float b2, float omb2, float eps,
                           void* stream) {
  if (n_leaves < 1) return -static_cast<int>(cudaErrorInvalidValue);
  static int blocks_fit = 0;
  if (blocks_fit == 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return -static_cast<int>(err);
    blocks_fit = sms * kBlocksPerSm;
  }
  const Coef c{a, r, b1, omb1, b2, omb2, eps};
  int launches = 0;
  for (int l0 = 0; l0 < n_leaves; l0 += kMaxLeaves) {
    Table tab;
    tab.n_leaves = n_leaves - l0 < kMaxLeaves ? n_leaves - l0 : kMaxLeaves;
    long long chunks = 0;
    for (int i = 0; i < tab.n_leaves; ++i) {
      const void* const* q = ptrs + 4 * (l0 + i);
      const long long n = lengths[l0 + i];
      if (n < 1) return -static_cast<int>(cudaErrorInvalidValue);
      tab.leaf[i] = Leaf{static_cast<float*>(const_cast<void*>(q[0])),
                         static_cast<const float*>(q[1]),
                         static_cast<float*>(const_cast<void*>(q[2])),
                         static_cast<float*>(const_cast<void*>(q[3])), n};
      chunks += (n + kChunk - 1) / kChunk;
      if (chunks > 0x7fffffffLL)
        return -static_cast<int>(cudaErrorInvalidValue);
      tab.chunk_end[i] = static_cast<int>(chunks);
    }
    const int blocks =
        static_cast<int>(chunks < blocks_fit ? chunks : blocks_fit);
    adam_leaves_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(tab, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launches;
  }
  return launches;
}

extern "C" const char* adam_leaves_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
