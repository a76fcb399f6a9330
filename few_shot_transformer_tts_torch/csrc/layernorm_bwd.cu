// LayerNorm backward for Hopper (sm_90a): dx, dgamma, dbeta in one
// cooperative launch over x and dy.
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
// Bound.  Reads x and dy and writes dx (plus gamma and the [C] results): at
// the decoder shape N=7168, C=768, bf16 that is 33 MB, 9.9 us at 3.35 TB/s;
// about 16 flops per element is far below the compute bound.  So the design
// keeps every byte of x and dy read once, with enough of them in flight.
//
// Design.  The TPU kernel walks the row tiles in order on one core and keeps
// dgamma/dbeta in its revisited output block; Hopper blocks run in parallel,
// so the column sums need a cross-block stage.  One launch does both stages,
// deterministically and with no atomics on values:
//   * Rows.  A persistent grid of 8-warp blocks, one per SM (never more
//     than are co-resident, fewer for short inputs), each owning a
//     contiguous range of rows; warp w takes rows w, w + 8, ... of the
//     range.  Each warp streams its rows through a ring of `depth` (2-4)
//     slots of shared memory with 16-byte cp.async copies issued depth - 1
//     rows ahead, so a warp keeps several rows of x and dy in flight
//     whatever registers it holds.  A lane reads its share of a row from the
//     slot as 16-byte vectors (8 bf16 or 4 fp32 contiguous columns; lane j
//     owns vectors j, j + 32, ...) and unpacks it to fp32 once; the row
//     statistics are warp shuffles.  Each lane sums its columns'
//     dgamma/dbeta terms over the warp's rows in row order.
//   * Block partials.  The 8 warps' sums meet in shared memory in warp
//     order, and the block writes one partial row [2, C] (dgamma then
//     dbeta) to a persistent workspace (a grid of one block writes dgamma
//     and dbeta themselves and stops here).
//   * Grid barrier (decoder_step.cu's: a 64-bit arrival count that only
//     grows, one per grid size, so it is a multiple of the grid at every
//     launch's start).
//   * Column sums.  The 2C partial columns are cut into chunks, chunk k on
//     block k mod grid; G thread groups of a block (G the largest power of
//     two up to 16 and the grid) each sum every G-th partial row in block
//     order, and the groups' sums are added in group order.  The order
//     depends only on the grid, so two calls give the same bits.
// A row whose bytes are not a multiple of 16, or pointers that are not
// 16-byte aligned, take the scalar-load variant of the same kernel: lane j
// loads columns j, j + 32, ... into registers, the next row's loads issued
// before the current row's reductions.  C <= 1024 (32 columns per lane).
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches one kernel on the given stream, allocates nothing (the workspace
// and the barrier count come from the caller) and returns the launch error.
// The caller sizes the grid and the ring (ops/layernorm.py ln_bwd_plan)
// from ln_bwd_blocks_per_sm, which also allows the instantiation its
// shared memory on the current device.  With a trace buffer each block
// stamps the global timer at the stage boundaries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroups = 16;  // partial-row groups of a column-sum chunk
constexpr int kMaxCols = 1024;
constexpr int kMaxDepth = 4;    // ring slots per warp
// the largest shared memory a launch asks for: a ring of 2 slots of an fp32
// row of x and dy at C = 1024 per warp (ops/layernorm.py ln_bwd_smem)
constexpr int kMaxSmem = kWarps * 2 * 2 * kMaxCols * 4;

struct Params {
  const void* x;
  const float* gamma;
  const void* dy;
  void* dx;
  float* dgamma;
  float* dbeta;
  float* partial;            // [gridDim.x, 2, cols]
  unsigned long long* bar;   // this grid size's arrival count
  int rows, cols, rows_per_block;
  int depth;                 // ring slots per warp (the vector variant)
  float eps;
  unsigned long long* trace;  // null, or kTraceStamps per block
};

// a block's global-timer stamps (ns), when traced: its start, its rows done,
// its partial row written, the grid barrier passed, its end
constexpr int kTraceStamps = 5;

// ---- the grid barrier ----------------------------------------------------

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait that outlasts any call (10 s) means a fault: abort the launch (the
// wrapper's next call on the device raises) rather than hold the card.
constexpr unsigned long long kWaitLimitNs = 10000000000ull;

struct Deadline {
  unsigned long long start = 0;
  unsigned n = 0;
  __device__ void check() {
    if ((++n & 1023u) == 0) {
      const unsigned long long t = now_ns();
      if (start == 0) {
        start = t;
      } else if (t - start > kWaitLimitNs) {
        __trap();
      }
    }
  }
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// ---- the ring ----------------------------------------------------------------

// 16 bytes from global to shared memory, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (< kMaxDepth) of this thread's groups are in
// flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (pending == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Every block arrives once.  The count only grows and every launch on it has
// this grid size, so at a launch's start it is a multiple of the grid: a
// block's arrival returns the count before it, which rounds down to that
// base, and the block waits for base + grid.  The arrival releases the
// block's partial row (its threads' writes, ordered before it by the
// __syncthreads) and the wait acquires every other block's.
__device__ void grid_barrier(unsigned long long* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long old;
    asm volatile("atom.add.acq_rel.gpu.global.u64 %0, [%1], 1;\n"
                 : "=l"(old)
                 : "l"(count)
                 : "memory");
    const unsigned long long target = old - old % gridDim.x + gridDim.x;
    Deadline dl;
    while (ld_acquire(count) < target) dl.check();
  }
  __syncthreads();
}

// two sums at once: their shuffles interleave
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

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

// A lane's share of one row of x and of dy: kN values each.  kVec: 16-byte
// vectors of V = 16 / sizeof(T) columns, value s in vector s / V, kept as
// loaded (bf16 pairs); lane j owns vectors j, j + 32, ....  Scalar: value s
// is column lane + 32 s.  Columns past the row read as 0.
template <typename T, int kN, bool kVec>
struct Row;

template <typename T, int kN>
struct Row<T, kN, true> {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int kVecs = kN / V;
  uint4 x[kVecs], dy[kVecs];

  __device__ static int col(int lane, int s) {
    return ((s / V) * 32 + lane) * V + s % V;
  }
  __device__ static bool valid(int lane, int s, int cols) {
    return ((s / V) * 32 + lane) * V < cols;  // cols is a multiple of V
  }
  // from a ring slot: nvec vectors of x, then nvec of dy
  __device__ void load(const uint4* slot, int nvec, int lane) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int i = v * 32 + lane;
      x[v] = dy[v] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvec) {
        x[v] = slot[i];
        dy[v] = slot[nvec + i];
      }
    }
  }
  __device__ static float get(const uint4 (&a)[kVecs], int s) {
    const uint4 q = a[s / V];
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[s % 4]);
    } else {  // a bf16 pair: the even column in the low half
      const unsigned u = w[(s % 8) / 2];
      return __uint_as_float(s % 2 ? u & 0xffff0000u : u << 16);
    }
  }
  __device__ float xv(int s) const { return get(x, s); }
  __device__ float dyv(int s) const { return get(dy, s); }
  // the lane's column sums into a [cols] fp32 row of shared memory
  __device__ static void store_sums(float* row, const float (&a)[kN],
                                    int lane, int cols) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c >= cols) continue;
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(row + c + i) =
            make_float4(a[v * V + i], a[v * V + i + 1], a[v * V + i + 2],
                        a[v * V + i + 3]);
    }
  }
  __device__ static void store(T* dxr, const float (&d)[kN], int lane,
                               int cols) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int c = (v * 32 + lane) * V;
      if (c >= cols) continue;
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4) {
          w[i] = __float_as_uint(d[v * V + i]);
        } else {
          const __nv_bfloat162 h =
              __floats2bfloat162_rn(d[v * V + 2 * i], d[v * V + 2 * i + 1]);
          w[i] = *reinterpret_cast<const unsigned*>(&h);
        }
      }
      *reinterpret_cast<uint4*>(dxr + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

template <typename T, int kN>
struct Row<T, kN, false> {
  T x[kN], dy[kN];

  __device__ static int col(int lane, int s) { return lane + 32 * s; }
  __device__ static bool valid(int lane, int s, int cols) {
    return lane + 32 * s < cols;
  }
  __device__ void load(const T* xr, const T* dyr, int lane, int cols) {
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const int c = lane + 32 * s;
      x[s] = c < cols ? xr[c] : from_float<T>(0.f);
      dy[s] = c < cols ? dyr[c] : from_float<T>(0.f);
    }
  }
  __device__ float xv(int s) const { return to_float(x[s]); }
  __device__ float dyv(int s) const { return to_float(dy[s]); }
  __device__ static void store_sums(float* row, const float (&a)[kN],
                                    int lane, int cols) {
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const int c = lane + 32 * s;
      if (c < cols) row[c] = a[s];
    }
  }
  __device__ static void store(T* dxr, const float (&d)[kN], int lane,
                               int cols) {
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      const int c = lane + 32 * s;
      if (c < cols) dxr[c] = from_float<T>(d[s]);
    }
  }
};

// One row through the TPU kernel's math: dx stored, the lane's dgamma/dbeta
// terms added to acc_g/acc_b.  The row is unpacked to fp32 once, and xhat
// and g are kept from the second pass for the third.
template <typename T, int kN, bool kVec>
__device__ __forceinline__ void row_backward(
    const Row<T, kN, kVec>& row, const float (&gam)[kN], float (&acc_g)[kN],
    float (&acc_b)[kN], T* dxr, int lane, int cols, float eps) {
  const float inv_c = 1.f / static_cast<float>(cols);
  float xh[kN], dy[kN], g[kN];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    xh[i] = row.xv(i);
    dy[i] = row.dyv(i);
    s += xh[i];
    s2 += xh[i] * xh[i];
  }
  warp_sum2(s, s2);
  const float mean = s * inv_c;
  const float rstd = rsqrtf(fmaxf(s2 * inv_c - mean * mean, 0.f) + eps);
  float sgx = 0.f, sg = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    xh[i] = (xh[i] - mean) * rstd;  // xhat; g is 0 beyond cols
    g[i] = dy[i] * gam[i];
    sgx += g[i] * xh[i];
    sg += g[i];
  }
  warp_sum2(sgx, sg);
  const float s1 = sgx * inv_c, s0 = sg * inv_c;
  float d[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    d[i] = rstd * (g[i] - xh[i] * s1 - s0);
    acc_g[i] += dy[i] * xh[i];  // dy is 0 beyond cols
    acc_b[i] += dy[i];
  }
  Row<T, kN, kVec>::store(dxr, d, lane, cols);
}

__device__ __forceinline__ void stamp(const Params& p, int k) {
  if (p.trace != nullptr && threadIdx.x == 0)
    p.trace[blockIdx.x * kTraceStamps + k] = now_ns();
}

// Stage 1, the vector variant: the warp's rows through its ring of slots.
template <typename T, int kN>
__device__ __forceinline__ void rows_through_ring(
    const Params& p, uint4* ring, const float (&gam)[kN], float (&acc_g)[kN],
    float (&acc_b)[kN], int warp, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int cols = p.cols, nvec = cols / V, depth = p.depth;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  T* dx = static_cast<T*>(p.dx);
  uint4* mine = ring + static_cast<long long>(warp) * depth * 2 * nvec;
  const long long first =
      static_cast<long long>(blockIdx.x) * p.rows_per_block + warp;
  const long long end =
      min(static_cast<long long>(p.rows),
          static_cast<long long>(blockIdx.x + 1) * p.rows_per_block);
  const int n = first < end ? static_cast<int>((end - first + kWarps - 1) /
                                               kWarps)
                            : 0;
  // row i of the warp into slot i mod depth; one commit group per row, empty
  // past the last, so row i's group is complete when depth - 1 are pending
  auto issue = [&](int i) {
    if (i < n) {
      const long long r = first + static_cast<long long>(i) * kWarps;
      uint4* slot = mine + (i % depth) * 2 * nvec;
      const uint4* xs = reinterpret_cast<const uint4*>(x + r * cols);
      const uint4* ds = reinterpret_cast<const uint4*>(dy + r * cols);
#pragma unroll
      for (int v = 0; v < kN / V; ++v) {
        const int k = v * 32 + lane;
        if (k < nvec) {
          cp_async16(slot + k, xs + k);
          cp_async16(slot + nvec + k, ds + k);
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < depth - 1; ++i) issue(i);
  for (int i = 0; i < n; ++i) {
    issue(i + depth - 1);
    cp_async_wait(depth - 1);
    __syncwarp();  // every lane's copies of row i have landed
    Row<T, kN, true> row;
    row.load(mine + (i % depth) * 2 * nvec, nvec, lane);
    row_backward(row, gam, acc_g, acc_b,
                 dx + (first + static_cast<long long>(i) * kWarps) * cols,
                 lane, cols, p.eps);
    __syncwarp();  // the slot is read before the next issue refills it
  }
}

// Stage 1, the scalar variant: rows loaded into registers, two per warp.
template <typename T, int kN>
__device__ __forceinline__ void rows_in_registers(
    const Params& p, const float (&gam)[kN], float (&acc_g)[kN],
    float (&acc_b)[kN], int warp, int lane) {
  using R = Row<T, kN, false>;
  const int cols = p.cols;
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  T* dx = static_cast<T*>(p.dx);
  const long long end =
      min(static_cast<long long>(p.rows),
          static_cast<long long>(blockIdx.x + 1) * p.rows_per_block);
  long long r = static_cast<long long>(blockIdx.x) * p.rows_per_block + warp;
  R a, b;
  if (r < end) a.load(x + r * cols, dy + r * cols, lane, cols);
  while (r < end) {
    if (r + kWarps < end)
      b.load(x + (r + kWarps) * cols, dy + (r + kWarps) * cols, lane, cols);
    row_backward(a, gam, acc_g, acc_b, dx + r * cols, lane, cols, p.eps);
    r += kWarps;
    if (r >= end) break;
    if (r + kWarps < end)
      a.load(x + (r + kWarps) * cols, dy + (r + kWarps) * cols, lane, cols);
    row_backward(b, gam, acc_g, acc_b, dx + r * cols, lane, cols, p.eps);
    r += kWarps;
  }
}

template <typename T, int kN, bool kVec>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const Params p) {
  using R = Row<T, kN, kVec>;
  // the ring (vector variant), then [kWarps][2 cols] for the block's sums
  extern __shared__ uint4 smem[];
  __shared__ float chunk_red[kThreads];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cols = p.cols;
  stamp(p, 0);

  float gam[kN], acc_g[kN], acc_b[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    gam[i] = R::valid(lane, i, cols) ? p.gamma[R::col(lane, i)] : 0.f;
    acc_g[i] = acc_b[i] = 0.f;
  }

  // stage 1: the block's rows
  if constexpr (kVec)
    rows_through_ring<T, kN>(p, smem, gam, acc_g, acc_b, warp, lane);
  else
    rows_in_registers<T, kN>(p, gam, acc_g, acc_b, warp, lane);

  // the block's partial row [dgamma, dbeta]: the warps' sums in warp order
  // (in [kWarps][2 cols] over the ring, which every warp has left at the
  // first __syncthreads)
  float* red = reinterpret_cast<float*>(smem);
  const int total = 2 * cols;
  __syncthreads();
  stamp(p, 1);
  R::store_sums(red + warp * total, acc_g, lane, cols);
  R::store_sums(red + warp * total + cols, acc_b, lane, cols);
  __syncthreads();
  const bool alone = gridDim.x == 1;
  float* out = p.partial + static_cast<long long>(blockIdx.x) * total;
  for (int q = tid; q < total; q += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w * total + q];
    if (!alone)
      out[q] = t;
    else if (q < cols)
      p.dgamma[q] = t;
    else
      p.dbeta[q - cols] = t;
  }
  stamp(p, 2);
  if (alone) return;

  grid_barrier(p.bar);
  stamp(p, 3);

  // stage 2: column sums over the partial rows in block order, eight rows'
  // loads in flight per thread
  const int parts = gridDim.x;
  int groups = kMaxGroups;
  while (groups > parts) groups >>= 1;
  const int width = kThreads / groups;  // columns of a chunk
  const int j = tid % width, grp = tid / width;
  for (int chunk = blockIdx.x; chunk * width < total; chunk += gridDim.x) {
    const int q = chunk * width + j;
    float t = 0.f;
    if (q < total) {
      for (int first = grp; first < parts; first += 8 * groups) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int part = first + k * groups;
          v[k] = part < parts ? __ldcg(p.partial +
                                       static_cast<long long>(part) * total + q)
                              : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) t += v[k];
      }
    }
    chunk_red[tid] = t;
    __syncthreads();
    if (tid < width && q < total) {
      float sum = 0.f;
      for (int g = 0; g < groups; ++g) sum += chunk_red[g * width + j];
      if (q < cols)
        p.dgamma[q] = sum;
      else
        p.dbeta[q - cols] = sum;
    }
    __syncthreads();
  }
  stamp(p, 4);
}

template <typename T, int kN, bool kVec>
cudaError_t launch(const Params& p, int grid, size_t smem,
                   cudaStream_t stream) {
  void* args[] = {const_cast<Params*>(&p)};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ln_bwd_kernel<T, kN, kVec>), dim3(grid),
      dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// allows the instantiation kMaxSmem on the current device, then counts its
// blocks per SM at smem bytes
template <typename T, int kN, bool kVec>
cudaError_t occupancy(size_t smem, int* blocks_per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      ln_bwd_kernel<T, kN, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ln_bwd_kernel<T, kN, kVec>, kThreads, smem);
}

// The instantiations: values per lane (kN) for each type and variant.  The
// vector variant holds whole 16-byte vectors (kN a multiple of 8 in bf16, 4
// in fp32); ops/layernorm.py's ln_bwd_plan keeps the same lists.
#define LN_VECTOR_BF16(X) X(__nv_bfloat16, 8, true) X(__nv_bfloat16, 16, true) \
  X(__nv_bfloat16, 24, true) X(__nv_bfloat16, 32, true)
#define LN_VECTOR_F32(X) X(float, 4, true) X(float, 8, true) \
  X(float, 16, true) X(float, 24, true) X(float, 32, true)
#define LN_SCALAR(X, T) X(T, 2, false) X(T, 4, false) X(T, 8, false) \
  X(T, 16, false) X(T, 24, false) X(T, 32, false)
#define LN_ALL(X) LN_VECTOR_BF16(X) LN_VECTOR_F32(X) \
  LN_SCALAR(X, __nv_bfloat16) LN_SCALAR(X, float)

template <typename T>
constexpr int dtype_code();
template <>
constexpr int dtype_code<float>() { return 0; }
template <>
constexpr int dtype_code<__nv_bfloat16>() { return 1; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx).  vector: 1 for the 16-byte
// variant (x, dy, dx 16-byte aligned and cols * sizeof(T) a multiple of 16),
// 0 for the scalar one; per_lane: one of the instantiated kN for them, with
// per_lane * 32 >= cols; depth: the vector variant's ring slots per warp
// (2 to 4); smem: the launch's dynamic shared memory, at least kWarps *
// max(depth * 2 * cols * sizeof(T), 2 * cols * 4) bytes (kWarps * 2 * cols
// * 4 for the scalar variant).  x, dy, dx [rows, cols] contiguous; gamma, dgamma,
// dbeta [cols] float32; partial a float32 workspace of [grid, 2, cols]; bar
// this grid size's uint64 arrival count (zero when made, only ever used by
// launches of this grid, one after another); block i owns rows
// [i * rows_per_block, (i + 1) * rows_per_block).  cols <= 1024; the grid
// must be co-resident (ln_bwd_blocks_per_sm, called first on the device).
// trace: null, or a uint64 [grid, kTraceStamps] that gets each block's
// global-timer stamps (ns): start, rows done, partial row written, grid
// barrier passed, end (a grid of one block stops after the third).
extern "C" int ln_bwd(int dtype, int vector, int per_lane, int depth,
                      const void* x, const void* gamma, const void* dy,
                      void* dx, void* dgamma, void* dbeta, void* partial,
                      void* bar, int rows, int cols, int rows_per_block,
                      int grid, int smem, float eps, void* trace,
                      void* stream) {
  const long long ring = vector ? static_cast<long long>(kWarps) * depth *
                                       2 * cols * (dtype == 0 ? 4 : 2)
                                 : 0;
  const long long sums = static_cast<long long>(kWarps) * 2 * cols * 4;
  const long long need = ring > sums ? ring : sums;
  if (cols < 1 || cols > kMaxCols || rows < 1 || grid < 1 ||
      rows_per_block < 1 ||
      static_cast<long long>(grid) * rows_per_block < rows ||
      (vector && (depth < 2 || depth > kMaxDepth)) || smem < need ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, static_cast<const float*>(gamma), dy, dx,
           static_cast<float*>(dgamma), static_cast<float*>(dbeta),
           static_cast<float*>(partial),
           static_cast<unsigned long long*>(bar), rows, cols, rows_per_block,
           depth, eps, static_cast<unsigned long long*>(trace)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LN_LAUNCH(T, K, VEC)                                              \
  if (dtype == dtype_code<T>() && vector == VEC && per_lane == K)       \
    return static_cast<int>(launch<T, K, VEC>(p, grid, smem, s));
  LN_ALL(LN_LAUNCH)
#undef LN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the instantiation (dtype, vector, per_lane) that fit on one SM
// of the current device with smem bytes of dynamic shared memory, into
// *blocks_per_sm; allows the instantiation its shared memory there.
extern "C" int ln_bwd_blocks_per_sm(int dtype, int vector, int per_lane,
                                    int smem, int* blocks_per_sm) {
  if (smem < 0 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
#define LN_OCCUPANCY(T, K, VEC)                                         \
  if (dtype == dtype_code<T>() && vector == VEC && per_lane == K)     \
    return static_cast<int>(occupancy<T, K, VEC>(smem, blocks_per_sm));
  LN_ALL(LN_OCCUPANCY)
#undef LN_OCCUPANCY
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ln_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
