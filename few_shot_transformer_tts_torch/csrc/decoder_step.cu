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
// padded to 256) a frame must read 99.1 MB of weights and 37.7 MB of memory
// K/V, plus 0.147 MB of self cache per decoded position: 41 us at step 0 and
// 64 us at step 511 at 3.35 TB/s; ~0.8 GFLOP per frame is negligible.  Every
// one of those bytes is known when the launch starts: only the [B, C] fp32
// residual stream (24 KB) flows from stage to stage.
//
// Design.  One persistent block per SM, launched cooperatively (the blocks
// must be co-resident for the grid barriers).  Each block has 8 consumer
// warps and one producer warp.
//   * Ownership.  The weights come pre-tiled (ops/decode.py
//     `pack_decoder_weights`): each stage's [K, N] matrix is cut into units
//     of 16 output columns x all K rows, stored as 16 x 16 k-tiles in the
//     mma A-fragment order of a warp (512 bytes, one 16-byte load per
//     lane).  A schedule table (ops/decode.py `decoder_schedule`) gives
//     each block its units of every stage, balanced by bytes over the
//     layer; it is the same for every layer, so each weight byte is read
//     once per frame (once per 8 batch rows).  Attention is split into
//     items (b, h, chunk of positions), nch chunks per (b, h), item i on
//     block i mod grid.
//   * The producer.  Nothing a block loads depends on the activations, so
//     the producer warp walks the block's whole frame -- every layer, every
//     stage's units, every attention item's K then V rows -- and keeps
//     bulk asynchronous copies (cp.async.bulk, completing on an mbarrier
//     with the byte count) in flight into a ring of 16 KB slots in shared
//     memory, one slot per load, as far ahead as the ring allows.  A slot
//     is refilled only after all 8 consumer warps have arrived on its
//     `empty` barrier.  Grid barriers gate the consumers only.
//   * Products on the tensor cores.  For bf16 weights each consumer warp
//     runs mma.sync m16n8k16 on its share of a slot's k-tiles: the weight
//     tile is A (16 columns x 16 of K), the activations B (8 batch rows);
//     B > 8 runs the stage once per 8 rows.  Each tile's product starts
//     from zero and is added to the warp's sums in fp64.  The stage's input
//     rows lie whole in global memory, so one thread bulk-copies them into
//     shared memory: the attention context and round(relu(FFN hidden)),
//     already rounded to the weights' type by the stage that wrote them, or
//     x with the LN's scale and bias, from which the block forms round(LN)
//     itself.  fp32 weights take the same tiles with scalar FMA (TF32 would
//     change the reference's numerics).  The 8 warps' partial sums are
//     added in warp order in fp64 and rounded once to fp32: no K split
//     crosses blocks and no float atomics are used, so the same inputs give
//     the same bits.  A column's owner writes its output, adding the
//     residual in place.
//   * Attention over all SMs in two passes: (1) a block computes the logits
//     of its chunk (bf16: __hmul2 rounds each q_d k_d once; the head sum is
//     fp64, rounded once), keeps them (in shared memory when it has one
//     item of at most kWindow positions, else in scratch), and publishes
//     its chunk's max and sum (and the fresh logit) with an arrive counter
//     per (b, h); (2) once every chunk of its (b, h) has arrived (a wait
//     among those blocks only), it combines their statistics in chunk order
//     and adds round(exp(s - m) / l) v over its positions in fp64; the last
//     chunk to finish sums the chunks' contexts in chunk order and writes
//     round(ctx).  No position count is capped by shared memory.
//   * Barriers.  A grid barrier of its own (GridBarrier: a release-add on a
//     64-bit count that only grows, an acquire poll; the producer never
//     takes part) after every stage but the last: 8 L - 1 per frame (8 L
//     with a trace), 47 at six layers.  Every wait is bounded: one that
//     outlasts any frame (10 s) aborts the launch instead of holding the
//     card.
//   Every long sum (products, logits, contexts) is fp64 and rounded once to
//   fp32, so a value near a bf16 rounding midpoint lands on the side the
//   exact sum does: the plain version's fp32 sums differ from the exact
//   ones by a few ulps, and a flipped rounding would move everything after.

// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kSlotBytes = 16384;
constexpr int kMaxSlots = 12;
constexpr int kRows = 8;                   // batch rows per product pass
constexpr int kStages = 6;                 // products per layer
constexpr int kWindow = 1024;              // attention weights staged at once
constexpr int kSmemLimit = 232448;         // 227 KB
constexpr float kEps = 1e-6f;

// the 16 x 16 k-tile of a weight unit, and the K rows one slot holds
template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kBytes = 512;
  static constexpr int kSlotK = kSlotBytes / kBytes * 16;  // 512
  static constexpr int kVec = 8;
};
template <>
struct Tile<float> {
  static constexpr int kBytes = 1024;
  static constexpr int kSlotK = kSlotBytes / kBytes * 16;  // 256
  static constexpr int kVec = 4;
};

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
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait that outlasts any frame (10 s) means a fault in the schedule:
// abort the launch (the wrapper's next call on the device raises) rather
// than hold the card.
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

// ---- mbarriers and bulk copies -------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const unsigned a = smem_u32(b);
  unsigned ok = 0;
  Deadline dl;
  do {
    dl.check();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on mbarrier b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// ---- barriers ------------------------------------------------------------

// the consumer warps only (the producer never waits here)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// +1 at p, ordered after this thread's earlier writes and those it has
// seen (a block's, after a bar.sync): a counter other blocks poll
__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// +1 at p, returning the old count: releases the writes before it and
// acquires those of every earlier +1
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// orders this thread's generic-proxy accesses before later async copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The grid barrier: one 64-bit arrival count that only grows.  Between
// barriers it is a multiple of the grid (every block arrived), across
// launches too, so a block that reads it before its first arrival rounds
// it down to this launch's base; barrier k then waits for base + (k + 1)
// grid arrivals.  One release-add per block and an acquire poll: no
// reset, no second word.
struct GridBarrier {
  unsigned long long* count;
  unsigned long long target;
  __device__ void init(unsigned long long* c) {
    count = c;
    const unsigned long long now = ld_acquire(c);
    target = now - now % gridDim.x;
  }
  // the consumer warps of every block; thread 0 arrives and waits
  __device__ void sync() {
    // the next stage bulk-copies into shared memory this stage read
    fence_proxy_async();
    consumers_sync();
    if (threadIdx.x == 0) {
      target += gridDim.x;
      asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(count)
                   : "memory");
      Deadline dl;
      while (ld_acquire(count) < target) dl.check();
    }
    consumers_sync();
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the consumer threads' sum in warp order; red holds kConsumerWarps
__device__ double consumers_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  consumers_sync();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  consumers_sync();
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < kConsumerWarps; ++i) s += red[i];
  return s;
}

// Softmax statistics (max m, sum of exp(s - m)) over every thread's
// (m, l) pair, combined in warp order; red holds 2 kConsumerWarps floats.
__device__ __forceinline__ void combine(float& m, float& l, float m2,
                                        float l2) {
  const float mn = fmaxf(m, m2);
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) +
      (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

__device__ void consumers_softmax_stats(float m, float l, float* red,
                                        float* m_out, float* l_out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    combine(m, l, m2, l2);
  }
  consumers_sync();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = m;
    red[kConsumerWarps + (threadIdx.x >> 5)] = l;
  }
  consumers_sync();
  m = red[0];
  l = red[kConsumerWarps];
  for (int i = 1; i < kConsumerWarps; ++i)
    combine(m, l, red[i], red[kConsumerWarps + i]);
  *m_out = m;
  *l_out = l;
}

// ---- parameters ----------------------------------------------------------

template <typename T>
struct Params {
  const float* x;          // [B, C] fp32
  const float* lns;        // [L, 6, C] fp32
  const T* tiles;          // [L, layer_elems] pre-tiled weights
  const T* cache_k;        // [L, B, Tcap, C]
  const T* cache_v;
  const T* mem_k;          // [L, B, Tm, C]
  const T* mem_v;
  const float* mem_bias;   // [B, Tm] fp32
  float* x_out;            // [B, C] fp32, also the residual stream
  float* align;            // [L, B, Tm, H] fp32
  T* k_new;                // [L, B, C]
  T* v_new;
  float* qkv;              // scratch [B, 3C]
  float* qx;               // scratch [B, C]
  T* hid;                  // scratch [B, F]: round(relu(ffn1 output))
  T* ctx;                  // scratch [B, C]: round(attention context)
  double* ctxp;            // scratch [nch, B, C]: attention chunk contexts
  float* lg;               // scratch [B, H, max(Tcap, Tm)]: logits
  float4* ex;              // scratch [B, H, nch]: chunk (max, sum), and
                           // chunk 0's fresh logit
  unsigned* cnt;           // scratch [L, 2, 2, B, H]: chunks published,
                           // then chunk contexts written
  unsigned long long* bar;  // grid barrier arrivals (persistent)
  const int* sched_off;    // [grid + 1]
  const int* sched;        // (stage << 16 | unit), by block, stage, unit
  unsigned long long* trace;  // [8L + 2] stage timeline, or null
  long long layer_elems;
  long long stage_off[kStages];  // element offset of each stage in a layer
  int stage_k[kStages], stage_n[kStages];
  int step, n_layers, batch, t_cap, t_mem, c, heads, head_dim;
  int lg_len, n_slots, act_ld;
  float scale;
};

// Block 0 stamps the global timer (ns) as it passes stage boundary i.
template <typename T>
__device__ __forceinline__ void mark(const Params<T>& p, int i) {
  if (p.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    p.trace[i] = now_ns();
}

__host__ __device__ __forceinline__ int rup16(int x) { return (x + 15) & ~15; }

// chunks per (b, h) of an attention over n positions
__host__ __device__ __forceinline__ int chunks(int n, int bh, int grid) {
  const int by_grid = grid / bh > 1 ? grid / bh : 1;
  const int by_len = n > 64 ? (n + 63) / 64 : 1;
  return by_grid < by_len ? by_grid : by_len;
}

// positions [*p0, *p1) of chunk c of n
__device__ __forceinline__ void chunk_range(int n, int nch, int c, int* p0,
                                            int* p1) {
  *p0 = static_cast<int>(static_cast<long long>(n) * c / nch);
  *p1 = static_cast<int>(static_cast<long long>(n) * (c + 1) / nch);
}

// The attention of a stage: self (kind 0, over the cache prefix) or cross
// (kind 1, over the memory).
template <typename T>
struct Attn {
  const T* k;
  const T* v;
  int n, len, nch;
  __device__ Attn(const Params<T>& p, int l, int kind) {
    const int b_stride = kind == 0 ? p.t_cap : p.t_mem;
    k = (kind == 0 ? p.cache_k : p.mem_k) +
        static_cast<long long>(l) * p.batch * b_stride * p.c;
    v = (kind == 0 ? p.cache_v : p.mem_v) +
        static_cast<long long>(l) * p.batch * b_stride * p.c;
    n = kind == 0 ? p.step : p.t_mem;
    len = b_stride;
    nch = chunks(n, p.batch * p.heads, gridDim.x);
  }
  // row t of head h of batch row b
  __device__ const T* row(const T* base, const Params<T>& p, int b, int h,
                          int t) const {
    return base + (static_cast<long long>(b) * len + t) * p.c +
           h * p.head_dim;
  }
};

// Positions of one head's rows per ring slot.
__device__ __forceinline__ int rows_per_slot(int row_bytes) {
  return kSlotBytes / row_bytes;
}

// the ring position: slot and phase of the it-th load
struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int n, it;
  __device__ int slot() const { return it % n; }
  __device__ unsigned phase() const { return (it / n) & 1; }
  __device__ unsigned char* data() const {
    return slots + static_cast<long long>(slot()) * kSlotBytes;
  }
};


// Shared memory: the ring, its barriers, the staged activations, the
// warps' partial sums and a work area (LN rows, or attention q and context
// partials); byte offsets from Layout.
template <typename T>
struct Smem {
  Ring ring;
  T* act;         // [kRows][act_ld]
  double* red;    // [kConsumerWarps][16 * kRows] warp partial sums
  float* work;
  float* small;   // block reductions [0, 16), LN statistics [16, 32), the
                  // schedule [32, 40) and a flag [40]
  double* small_d;  // fp64 block reductions [kConsumerWarps]
  int* sb;        // the block's schedule entries per stage, [kStages + 1]
  uint64_t* act_bar;  // completes the bulk copies of a stage's activations
  unsigned act_uses;  // stagings so far (the barrier's phase)
};

// ---------------------------------------------------------------------------
// the producer warp
// ---------------------------------------------------------------------------

template <typename T>
struct Producer {
  Ring& ring;
  int lane;
  // wait until the next slot is free (lane 0), then announce bytes
  __device__ unsigned char* begin(unsigned bytes) {
    if (lane == 0) {
      mbar_wait(&ring.empty[ring.slot()], ring.phase() ^ 1u);
      mbar_expect(&ring.full[ring.slot()], bytes);
    }
    __syncwarp();
    return ring.data();
  }
  __device__ void end() {
    __syncwarp();
    ++ring.it;
  }
};

template <typename T>
__device__ void produce_units(const Params<T>& p, int l, int s,
                              const int* sb, const int* mine,
                              Producer<T>& pr) {
  constexpr int kSlotK = Tile<T>::kSlotK;
  const int kp = rup16(p.stage_k[s]);
  const T* layer = p.tiles + l * p.layer_elems + p.stage_off[s];
  const bool ln = s == 0 || s == 2 || s == 4;
  for (int r0 = 0; r0 < p.batch; r0 += kRows) {
    if (ln && sb[s] < sb[s + 1]) {  // the LN's scale and bias, one slot
      const unsigned bytes = 2 * p.c * sizeof(float);
      unsigned char* dst = pr.begin(bytes);
      if (pr.lane == 0)
        bulk_copy(dst, p.lns + (static_cast<long long>(l) * 6 + s) * p.c,
                  bytes, &pr.ring.full[pr.ring.slot()]);
      pr.end();
    }
    for (int e = sb[s]; e < sb[s + 1]; ++e) {
      const T* unit = layer + static_cast<long long>(mine[e] & 0xffff) *
                                  kp * 16;
      for (int k0 = 0; k0 < kp; k0 += kSlotK) {
        const unsigned bytes = min(kSlotK, kp - k0) * 16 * sizeof(T);
        unsigned char* dst = pr.begin(bytes);
        if (pr.lane == 0)
          bulk_copy(dst, unit + k0 * 16, bytes, &pr.ring.full[pr.ring.slot()]);
        pr.end();
      }
    }
  }
}

// each item's K rows (pass 1), then each item's V rows (pass 2)
template <typename T>
__device__ void produce_attention(const Params<T>& p, int l, int kind,
                                  Producer<T>& pr) {
  const Attn<T> at(p, l, kind);
  const int D = p.head_dim, H = p.heads, row = D * sizeof(T);
  const int per = rows_per_slot(row), items = p.batch * H * at.nch;
  for (int pass = 0; pass < 2; ++pass)
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const int bh = i / at.nch, c = i - bh * at.nch;
      int p0, p1;
      chunk_range(at.n, at.nch, c, &p0, &p1);
      for (int t0 = p0; t0 < p1; t0 += per) {
        const int n = min(per, p1 - t0);
        unsigned char* dst = pr.begin(n * row);
        for (int r = pr.lane; r < n; r += 32)
          bulk_copy(dst + r * row,
                    at.row(pass ? at.v : at.k, p, bh / H, bh % H, t0 + r),
                    row, &pr.ring.full[pr.ring.slot()]);
        pr.end();
      }
    }
}

template <typename T>
__device__ void producer(const Params<T>& p, const Smem<T>& sm,
                         const int* mine) {
  Ring ring = sm.ring;
  Producer<T> pr{ring, static_cast<int>(threadIdx.x & 31)};
  for (int l = 0; l < p.n_layers; ++l) {
    produce_units(p, l, 0, sm.sb, mine, pr);
    produce_attention(p, l, 0, pr);
    produce_units(p, l, 1, sm.sb, mine, pr);
    produce_units(p, l, 2, sm.sb, mine, pr);
    produce_attention(p, l, 1, pr);
    for (int s = 3; s < kStages; ++s) produce_units(p, l, s, sm.sb, mine, pr);
  }
}

// ---------------------------------------------------------------------------
// the consumer warps
// ---------------------------------------------------------------------------

__device__ __forceinline__ void acquire(const Ring& ring) {
  mbar_wait(&ring.full[ring.slot()], ring.phase());
}

__device__ __forceinline__ void release(Ring& ring) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[ring.slot()]);
  ++ring.it;
}

// Four activations at act[r, k..k+3], rounded to T.
__device__ __forceinline__ void put4(__nv_bfloat16* a, float4 v) {
  uint2 u;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(a) = u;
}
__device__ __forceinline__ void put4(float* a, float4 v) {
  *reinterpret_cast<float4*>(a) = v;
}

// The product's input rows r0 .. r0 + 7 for stage s, rounded to T, into
// act (zero past K and past the batch).  Every input lies in global memory
// as whole rows, written by other blocks before the stage's barrier, so
// one thread copies them in with bulk copies on act_bar: the attention
// context and round(relu(ffn1)) already in T straight into act's rows;
// for a LayerNorm, the fp32 rows of x and the LN's scale and bias into
// the work area, from which act is computed.
template <typename T>
__device__ void stage_activations(const Params<T>& p, int l, int s, int r0,
                                  Smem<T>& sm) {
  const int tid = threadIdx.x, C = p.c, B = p.batch;
  const int K = p.stage_k[s], kp = rup16(K), nr = min(kRows, B - r0);
  const bool ln = s == 0 || s == 2 || s == 4;
  T* act = sm.act;
  const int ld = p.act_ld;
  const float* x = ((l == 0 && s == 0) ? p.x : p.x_out) +
                   static_cast<long long>(r0) * C;
  float* xs = sm.work;  // [nr][C]
  if (r0 > 0) {  // the previous pass's units read act
    fence_proxy_async();
    consumers_sync();
  }
  // (after a grid barrier the generic accesses to act and the work area
  // are over and proxy-fenced: GridBarrier::sync)
  if (tid == 0) {
    if (ln) {
      const unsigned xb = nr * C * 4;
      mbar_expect(sm.act_bar, xb);
      bulk_copy(xs, x, xb, sm.act_bar);
    } else {
      const T* src = s == 5 ? p.hid + static_cast<long long>(r0) * K
                            : p.ctx + static_cast<long long>(r0) * C;
      const unsigned row = K * sizeof(T);
      mbar_expect(sm.act_bar, nr * row);
      for (int r = 0; r < nr; ++r)
        bulk_copy(act + r * ld, src + static_cast<long long>(r) * K, row,
                  sm.act_bar);
    }
  }
  // zeros past K (to the tile's 16) and past the batch, while they fly
  if (K < kp)
    for (int i = tid; i < nr * (kp - K); i += kConsumers) {
      const int r = i / (kp - K);
      act[r * ld + K + i - r * (kp - K)] = from_f<T>(0.f);
    }
  for (int i = tid; i < (kRows - nr) * kp; i += kConsumers) {
    const int r = nr + i / kp;
    act[r * ld + i % kp] = from_f<T>(0.f);
  }
  mbar_wait(sm.act_bar, sm.act_uses & 1);
  ++sm.act_uses;
  if (ln) {
    // the LN's scale and bias [2][C], streamed by the producer
    Ring& ring = sm.ring;
    acquire(ring);
    const float* gb = reinterpret_cast<const float*>(ring.data());
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < nr) {  // two-pass statistics, four sums in flight per lane
      const float4* row = reinterpret_cast<const float4*>(xs + warp * C);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = lane; i < C / 4; i += 32) {
        const float4 v = row[i];
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
      const float m = warp_sum((a.x + a.y) + (a.z + a.w)) / C;
      a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = lane; i < C / 4; i += 32) {
        const float4 v = row[i];
        a.x += (v.x - m) * (v.x - m);
        a.y += (v.y - m) * (v.y - m);
        a.z += (v.z - m) * (v.z - m);
        a.w += (v.w - m) * (v.w - m);
      }
      const float var = warp_sum((a.x + a.y) + (a.z + a.w)) / C;
      if (lane == 0) {
        sm.small[16 + warp] = m;
        sm.small[24 + warp] = 1.f / sqrtf(var + kEps);
      }
    }
    consumers_sync();
    const int k4 = C / 4;
    int r = tid / k4, q = tid - r * k4;  // (row, quad) of element tid
    for (int i = tid; i < nr * k4; i += kConsumers) {
      const int k = 4 * q;
      const float m = sm.small[16 + r], rs = sm.small[24 + r];
      const float4 xv = reinterpret_cast<const float4*>(xs)[i];
      const float4 g = *reinterpret_cast<const float4*>(gb + k);
      const float4 bt = *reinterpret_cast<const float4*>(gb + C + k);
      put4(act + r * ld + k,
           make_float4((xv.x - m) * rs * g.x + bt.x,
                       (xv.y - m) * rs * g.y + bt.y,
                       (xv.z - m) * rs * g.z + bt.z,
                       (xv.w - m) * rs * g.w + bt.w));
      for (q += kConsumers; q >= k4; q -= k4) ++r;
    }
    release(ring);
  }
  consumers_sync();
}

// One slot's k-tiles of a unit, this warp's share, into its fragment c
// (c0, c1: column g, rows 2t, 2t+1; c2, c3: column g + 8).
__device__ __forceinline__ void slot_tiles(const unsigned char* data,
                                           int n_tiles,
                                           const __nv_bfloat16* act, int ld,
                                           double (&c)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int kt = warp; kt < n_tiles; kt += kConsumerWarps) {
    const uint4 a = *reinterpret_cast<const uint4*>(data + kt * 512 +
                                                    lane * 16);
    const __nv_bfloat16* ar = act + g * ld + kt * 16 + 2 * t;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ar);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ar + 8);
    // each tile's 16-term sum from a zero accumulator, added to c in fp64:
    // the sum over thousands of terms rounds once, to fp32, at the end
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += d[e];
  }
}

// fp32: the same tiles and fragments with scalar FMA; acc[j][n] holds
// column g + 8 j, batch row n, over this lane's four k of each tile
__device__ __forceinline__ void slot_tiles(const unsigned char* data,
                                           int n_tiles, const float* act,
                                           int ld, float (&acc)[2][kRows]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  for (int kt = warp; kt < n_tiles; kt += kConsumerWarps) {
    const float4* wp =
        reinterpret_cast<const float4*>(data + kt * 1024 + lane * 32);
    const float4 w0 = wp[0], w1 = wp[1];
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      const float* ar = act + n * ld + kt * 16 + 2 * t;
      const float2 a0 = *reinterpret_cast<const float2*>(ar);
      const float2 a1 = *reinterpret_cast<const float2*>(ar + 8);
      float s0 = acc[0][n], s1 = acc[1][n];
      s0 = fmaf(w0.x, a0.x, s0);
      s0 = fmaf(w0.y, a0.y, s0);
      s0 = fmaf(w1.x, a1.x, s0);
      s0 = fmaf(w1.y, a1.y, s0);
      s1 = fmaf(w0.z, a0.x, s1);
      s1 = fmaf(w0.w, a0.y, s1);
      s1 = fmaf(w1.z, a1.x, s1);
      s1 = fmaf(w1.w, a1.y, s1);
      acc[0][n] = s0;
      acc[1][n] = s1;
    }
  }
}

// the fp32 sums of the four lanes of a k-tile row, then the mma C fragment
__device__ __forceinline__ void to_fragment(float (&acc)[2][kRows],
                                            double (&c)[4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int n = 0; n < kRows; ++n) {
      float v = acc[j][n];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      acc[j][n] = v;
    }
#pragma unroll
  for (int n = 0; n < kRows; n += 2)
    if (n == 2 * t) {
      c[0] = acc[0][n];
      c[1] = acc[0][n + 1];
      c[2] = acc[1][n];
      c[3] = acc[1][n + 1];
    }
}

// out[b, col] for the block's units of stage s, rows r0 .. r0 + 7
template <typename T>
__device__ void product(const Params<T>& p, int l, int s, int r0,
                        Smem<T>& sm, const int* mine) {
  constexpr int kSlotK = Tile<T>::kSlotK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kp = rup16(p.stage_k[s]), N = p.stage_n[s], C = p.c;
  const int nr = min(kRows, p.batch - r0);
  Ring& ring = sm.ring;
  if (sm.sb[s] == sm.sb[s + 1]) return;  // no unit of this stage here
  stage_activations(p, l, s, r0, sm);
  const bool residual = s == 1 || s == 3 || s == 5;
  const float* xin = (l == 0 && s == 1) ? p.x : p.x_out;
  for (int e = sm.sb[s]; e < sm.sb[s + 1]; ++e) {
    const int unit = mine[e] & 0xffff;
    // this thread's output of the unit, and its residual, read ahead
    const int m = tid / kRows, n = tid - m * kRows;
    const int b = r0 + n, col = unit * 16 + m;
    const bool mine_out = tid < 16 * kRows && n < nr && col < N;
    const float x_res =
        residual && mine_out
            ? __ldcg(xin + static_cast<long long>(b) * C + col)
            : 0.f;
    double c[4] = {0.0, 0.0, 0.0, 0.0};
    float acc[2][kRows];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[j][i] = 0.f;
    for (int k0 = 0; k0 < kp; k0 += kSlotK) {
      const int n_tiles = min(kSlotK, kp - k0) / 16;
      acquire(ring);
      if constexpr (sizeof(T) == 2)
        slot_tiles(ring.data(), n_tiles, sm.act + k0, p.act_ld, c);
      else
        slot_tiles(ring.data(), n_tiles, sm.act + k0, p.act_ld, acc);
      release(ring);
    }
    if constexpr (sizeof(T) == 4) to_fragment(acc, c);
    double* red = sm.red + warp * 16 * kRows;
    red[g * kRows + 2 * t] = c[0];
    red[g * kRows + 2 * t + 1] = c[1];
    red[(g + 8) * kRows + 2 * t] = c[2];
    red[(g + 8) * kRows + 2 * t + 1] = c[3];
    consumers_sync();
    if (mine_out) {
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        sum += sm.red[w * 16 * kRows + tid];
      const float r = static_cast<float>(sum);
      const long long o = static_cast<long long>(b) * N + col;
      if (s == 0) {
        p.qkv[o] = r;
      } else if (s == 2) {
        p.qx[o] = r;
      } else if (s == 4) {
        p.hid[o] = from_f<T>(fmaxf(r, 0.f));
      } else {  // residual: the column's owner adds in place
        p.x_out[o] = x_res + r;
      }
    }
    consumers_sync();
  }
}

// sum_d round(round(q_d) * k_d) over this lane's 16-byte vectors iv = j,
// j + lanes, ... of one row (bf16: __hmul2 rounds each product once), summed
// in fp64 (the head sum rounds once, to fp32, after the lanes' parts)
__device__ __forceinline__ double row_logit(const unsigned char* row,
                                            const __nv_bfloat16* q, int nvec,
                                            int j, int lanes) {
  double s = 0.0;
  for (int iv = j; iv < nvec; iv += lanes) {
    const uint4 kv = *reinterpret_cast<const uint4*>(row + iv * 16);
    const uint4 qv = *reinterpret_cast<const uint4*>(q + iv * 8);
    const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(__hmul2(q2[i], k2[i]));
      s += f.x;
      s += f.y;
    }
  }
  return s;
}

__device__ __forceinline__ double row_logit(const unsigned char* row,
                                            const float* q, int nvec, int j,
                                            int lanes) {
  double s = 0.0;
  for (int iv = j; iv < nvec; iv += lanes) {
    const float4 kv = *reinterpret_cast<const float4*>(row + iv * 16);
    const float4 qv = *reinterpret_cast<const float4*>(q + iv * 4);
    s += __fmul_rn(qv.x, kv.x);
    s += __fmul_rn(qv.y, kv.y);
    s += __fmul_rn(qv.z, kv.z);
    s += __fmul_rn(qv.w, kv.w);
  }
  return s;
}

template <typename T>
__device__ __forceinline__ void load_vec(const unsigned char* p,
                                         float (&f)[Tile<T>::kVec]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
}

// Self (kind 0) or cross (kind 1) attention of layer l over the block's
// items, in the two passes of the header.
template <typename T>
__device__ void attention(const Params<T>& p, int l, int kind, Smem<T>& sm) {
  constexpr int V = Tile<T>::kVec;
  const Attn<T> at(p, l, kind);
  const int tid = threadIdx.x, H = p.heads, D = p.head_dim, B = p.batch;
  const int C = p.c, bhn = B * H, nch = at.nch, items = bhn * nch;
  const int row = D * sizeof(T), per = rows_per_slot(row), nvec = D / V;
  constexpr int lanes = 4;  // threads that share one position's logit
  const int group = tid / lanes;
  const float* bias = p.mem_bias;
  // arrivals of the chunks' statistics, then of their contexts
  unsigned* cnt = p.cnt + (static_cast<long long>(l) * 2 + kind) * 2 * bhn;
  Ring& ring = sm.ring;
  T* q_s = reinterpret_cast<T*>(sm.work);
  double* red_ctx = reinterpret_cast<double*>(sm.work + (row + 15) / 16 * 4);
  // a window's rounded weights: kWindow positions
  float* w_s = reinterpret_cast<float*>(red_ctx + kConsumers * V);
  // a block with one item of at most kWindow positions keeps its logits in
  // shared memory between the passes, others in scratch
  float* lg_s = w_s + kWindow;
  const bool keep = items <= static_cast<int>(gridDim.x) &&
                    (at.n + nch - 1) / nch <= kWindow;
  const bool self = kind == 0;

  // pass 1: logits, the chunk's max and sum
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int bh = i / nch, c = i - bh * nch, b = bh / H, h = bh - b * H;
    int p0, p1;
    chunk_range(at.n, nch, c, &p0, &p1);
    const float* qsrc = self ? p.qkv + static_cast<long long>(b) * 3 * C
                             : p.qx + static_cast<long long>(b) * C;
    const bool fresh = self && c == 0;  // this item holds the fresh position
    const long long o = (static_cast<long long>(l) * B + b) * C + h * D;
    double part = 0.0;  // the fresh logit's terms
    consumers_sync();   // q_s of the previous item is consumed
    for (int d = tid; d < D; d += kConsumers) {
      const float q = __ldcg(qsrc + h * D + d) * p.scale;
      q_s[d] = from_f<T>(q);
      if (fresh) {  // k_new / v_new, and round(q_d k_d) for the fresh logit
        const float k = __ldcg(qsrc + C + h * D + d);
        part += rnd<T>(q * k);
        p.k_new[o + d] = from_f<T>(k);
        p.v_new[o + d] = from_f<T>(__ldcg(qsrc + 2 * C + h * D + d));
      }
    }
    consumers_sync();
    // the chunk's logits, position t at lg[t - p0]
    float* lg = keep ? lg_s : p.lg + static_cast<long long>(bh) * p.lg_len + p0;
    const int j = tid - group * lanes;  // this thread's lane of its row
    // each group leader's running max and sum over its positions
    float m_loc = -INFINITY, l_loc = 0.f;
    for (int t0 = p0; t0 < p1; t0 += per) {
      const int n = min(per, p1 - t0);
      acquire(ring);
      const unsigned char* data = ring.data();
      for (int r0 = 0; r0 < n; r0 += kConsumers / lanes) {
        const int r = r0 + group;
        // the padding bias is read before the dot, so its load overlaps it
        const float bv = !self && r < n && j == 0
                             ? __ldg(bias + static_cast<long long>(b) *
                                                p.t_mem + t0 + r)
                             : 0.f;
        double sd = r < n ? row_logit(data + r * row, q_s, nvec, j, lanes)
                          : 0.0;
        for (int off = 1; off < lanes; off <<= 1)
          sd += __shfl_xor_sync(0xffffffffu, sd, off);
        float s = static_cast<float>(sd);
        if (r < n && j == 0) {
          s += bv;
          lg[t0 + r - p0] = s;
          const float m_new = fmaxf(m_loc, s);
          l_loc = l_loc * expf(m_loc - m_new) + expf(s - m_new);
          m_loc = m_new;
        }
      }
      release(ring);
    }
    float sf = -INFINITY;  // the fresh logit
    if (fresh) sf = static_cast<float>(consumers_sum(part, sm.small_d));
    if (tid == 0 && fresh) {  // the fresh position joins
      const float m_new = fmaxf(m_loc, sf);
      l_loc = (m_loc == -INFINITY ? 0.f : l_loc * expf(m_loc - m_new)) +
              expf(sf - m_new);
      m_loc = m_new;
    }
    float m_c, l_c;
    consumers_softmax_stats(m_loc, l_loc, sm.small, &m_c, &l_c);
    if (tid == 0) {
      p.ex[static_cast<long long>(bh) * nch + c] =
          make_float4(m_c, l_c, sf, 0.f);
      red_release(cnt + bh);  // after the statistics, for the partners
    }
  }

  // pass 2: the global max and sum, then round(w) v over the chunk
  // thread (pg, iv): position group pg, 16-byte vector iv of the head
  // (the head's D / V vectors fit the consumer threads: run() checks)
  const int npg = kConsumers / nvec;
  const int pg = tid / nvec, iv = tid - pg * nvec;
  const bool active = pg < npg;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int bh = i / nch, c = i - bh * nch, b = bh / H, h = bh - b * H;
    int p0, p1;
    chunk_range(at.n, nch, c, &p0, &p1);
    const bool fresh = self && c == 0;
    const float* vf = p.qkv + static_cast<long long>(b) * 3 * C + 2 * C + h * D;
    // v of the fresh position, read while the chunks publish
    const float vf0 = fresh && tid < D ? __ldcg(vf + tid) : 0.f;
    consumers_sync();  // red_ctx of the previous item is consumed
    if (tid == 0) {
      Deadline dl;
      while (ld_acquire(cnt + bh) < static_cast<unsigned>(nch)) dl.check();
    }
    consumers_sync();
    // the chunks' statistics combined in chunk order
    const float4* ex = p.ex + static_cast<long long>(bh) * nch;
    float m = -INFINITY, den = 0.f, sf = 0.f;
    for (int cc = 0; cc < nch; ++cc) {
      const float4 e = __ldcg(&ex[cc]);
      combine(m, den, e.x, e.y);
      if (cc == 0) sf = e.z;
    }
    const float* lg =
        keep ? lg_s : p.lg + static_cast<long long>(bh) * p.lg_len + p0;
    float* al = p.align + (static_cast<long long>(l) * B + b) * p.t_mem * H + h;
    double acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0;
    // the rounded weights of a window of whole slots (at most kWindow
    // positions) at a time into w_s, one load per position
    const int window = kWindow / per * per;
    for (int t0 = p0; t0 < p1; t0 += per) {
      const int n = min(per, p1 - t0);
      const int w0 = (t0 - p0) % window;  // the slot's place in the window
      if (w0 == 0) {
        const int nw = min(window, p1 - t0);
        consumers_sync();  // the previous window's weights are consumed
        for (int r = tid; r < nw; r += kConsumers) {
          const float w =
              expf((keep ? lg[t0 + r - p0] : __ldcg(lg + t0 + r - p0)) - m) /
              den;
          if (!self) al[static_cast<long long>(t0 + r) * H] = w;
          w_s[r] = rnd<T>(w);
        }
        consumers_sync();
      }
      acquire(ring);
      const unsigned char* data = ring.data();
      if (active)
        for (int r = pg; r < n; r += npg) {
          const double rw = w_s[w0 + r];
          float v[V];
          load_vec<T>(data + r * row + iv * 16, v);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = __fma_rn(rw, static_cast<double>(v[e]), acc[e]);
        }
      release(ring);
    }
    if (active)
#pragma unroll
      for (int e = 0; e < V; ++e) red_ctx[pg * D + iv * V + e] = acc[e];
    consumers_sync();
    // the fresh position's rounded weight
    const float wf = fresh ? rnd<T>(expf(sf - m) / den) : 0.f;
    double* out = p.ctxp + (static_cast<long long>(c) * B + b) * C + h * D;
    T* dst = p.ctx + static_cast<long long>(b) * C + h * D;
    for (int d = tid; d < D; d += kConsumers) {
      double s = 0.0;
      for (int q = 0; q < npg; ++q) s += red_ctx[q * D + d];
      if (fresh)
        s += static_cast<double>(wf) *
             static_cast<double>(d == tid ? vf0 : __ldcg(vf + d));
      if (nch == 1) {
        dst[d] = from_f<T>(static_cast<float>(s));  // the whole context
      } else {
        out[d] = s;
      }
    }
    if (nch == 1) continue;
    // the last chunk of (b, h) to finish sums the chunks' contexts in
    // chunk order and rounds them once: ctx = round(fp32(sum))
    consumers_sync();
    if (tid == 0) {
      const unsigned done = add_acq_rel(cnt + bhn + bh);
      sm.small[40] = done == static_cast<unsigned>(nch - 1) ? 1.f : 0.f;
    }
    consumers_sync();
    if (sm.small[40] != 0.f) {
      const double* part = p.ctxp + static_cast<long long>(b) * C + h * D;
      for (int d = tid; d < D; d += kConsumers) {
        double sum = 0.0;
        for (int cc = 0; cc < nch; ++cc)
          sum += __ldcg(part + static_cast<long long>(cc) * B * C + d);
        dst[d] = from_f<T>(static_cast<float>(sum));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
decoder_step_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  mark(p, 0);
  const int tid = threadIdx.x, ns = p.n_slots;
  Smem<T> sm;
  sm.ring.slots = smem;
  sm.ring.full = reinterpret_cast<uint64_t*>(smem + ns * kSlotBytes);
  sm.ring.empty = sm.ring.full + ns;
  sm.ring.n = ns;
  sm.ring.it = 0;
  sm.act_bar = sm.ring.full + 2 * kMaxSlots;
  sm.act_uses = 0;
  sm.act = reinterpret_cast<T*>(sm.act_bar + 2);
  sm.red = reinterpret_cast<double*>(sm.act + kRows * p.act_ld);
  sm.small = reinterpret_cast<float*>(sm.red + kConsumerWarps * 16 * kRows);
  sm.sb = reinterpret_cast<int*>(sm.small + 32);
  sm.small_d = reinterpret_cast<double*>(sm.small + 48);
  sm.work = sm.small + 64;
  const int* mine = p.sched + p.sched_off[blockIdx.x];
  if (tid == 0) {
    for (int i = 0; i < ns; ++i) {
      mbar_init(&sm.ring.full[i], 1);
      mbar_init(&sm.ring.empty[i], kConsumerWarps);
    }
    mbar_init(sm.act_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the block's entries are sorted by stage: where each stage begins
    const int n = p.sched_off[blockIdx.x + 1] - p.sched_off[blockIdx.x];
    int e = 0;
    for (int s = 0; s <= kStages; ++s) {
      while (e < n && (mine[e] >> 16) < s) ++e;
      sm.sb[s] = e;
    }
  }
  // the exchange counters, first used after the first grid barrier
  const long long n_cnt =
      static_cast<long long>(p.n_layers) * 4 * p.batch * p.heads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + tid;
       i < n_cnt; i += static_cast<long long>(gridDim.x) * kThreads)
    p.cnt[i] = 0;
  __syncthreads();
  mark(p, 1);
  if (tid >= kConsumers) {
    producer(p, sm, mine);
    return;
  }
  GridBarrier bar;
  if (tid == 0) bar.init(p.bar);  // before this block's first arrival
  for (int l = 0; l < p.n_layers; ++l) {
    const int m0 = 2 + 8 * l;
    for (int r0 = 0; r0 < p.batch; r0 += kRows) product(p, l, 0, r0, sm, mine);
    bar.sync();
    mark(p, m0);
    attention(p, l, 0, sm);
    bar.sync();
    mark(p, m0 + 1);
    for (int s = 1; s < kStages; ++s) {
      for (int r0 = 0; r0 < p.batch; r0 += kRows)
        product(p, l, s, r0, sm, mine);
      if (s == kStages - 1 && l == p.n_layers - 1 && p.trace == nullptr)
        break;  // the frame's last stage: its owners wrote x_out
      bar.sync();
      mark(p, m0 + (s < 3 ? s + 1 : s + 2));
      if (s == 2) {
        attention(p, l, 1, sm);
        bar.sync();
        mark(p, m0 + 4);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Shape {
  int stage_k[kStages], stage_n[kStages];
  long long stage_off[kStages], layer_elems;
  int act_ld, n_slots;
  size_t smem;
};

// The tiled layout of one layer's weights (ops/decode.py
// pack_decoder_weights) and the shared memory of the launch; n_slots = 0
// when fewer than two ring slots fit.
Shape shape_of(int elt, int c, int f, int head_dim) {
  Shape s{};
  const int ks[kStages] = {c, c, c, c, c, f};
  const int ns[kStages] = {3 * c, c, c, c, f, c};
  long long off = 0;
  for (int i = 0; i < kStages; ++i) {
    s.stage_k[i] = ks[i];
    s.stage_n[i] = ns[i];
    s.stage_off[i] = off;
    off += static_cast<long long>(rup16(ks[i])) * rup16(ns[i]);
  }
  s.layer_elems = off;
  const int kmax = std::max(rup16(c), rup16(f));
  s.act_ld = (kmax + 63) / 64 * 64 + 8;
  const int vec = 16 / elt;
  const size_t row = (static_cast<size_t>(head_dim) * elt + 15) / 16 * 16;
  const size_t work = std::max(
      static_cast<size_t>(kRows) * c * 4,
      row + static_cast<size_t>(kConsumers) * vec * 8 +
          static_cast<size_t>(kWindow) * 2 * 4);
  const size_t fixed = (2 * kMaxSlots + 2) * 8 +
                       (static_cast<size_t>(kRows) * s.act_ld * elt + 15) /
                           16 * 16 +
                       kConsumerWarps * 16 * kRows * 8 + 64 * 4 + work;
  const long long room =
      (static_cast<long long>(kSmemLimit) - static_cast<long long>(fixed)) /
      kSlotBytes;
  s.n_slots = room < 2 ? 0 : static_cast<int>(std::min<long long>(room,
                                                                  kMaxSlots));
  s.smem = static_cast<size_t>(s.n_slots) * kSlotBytes + fixed;
  return s;
}

// scratch, each part 16-byte aligned: ex [B, H, nch] float4, ctxp [nch,
// B, C] double, ctx [B, C] and hid [B, F] in the weights' type (elt bytes),
// then qkv, qx, lg (float) and cnt (uint32)
struct Scratch {
  long long ex, ctxp, ctx, hid, qkv, qx, lg, cnt, bytes;
};

Scratch scratch_of(int elt, int n_layers, int batch, int c, int f,
                   int heads, int t_cap, int t_mem, int grid) {
  const long long b = batch, bh = b * heads;
  const int nch = std::max(1, grid / static_cast<int>(bh));
  auto next = [](long long at, long long bytes) {
    return (at + bytes + 15) / 16 * 16;
  };
  Scratch s;
  s.ex = 0;
  s.ctxp = next(s.ex, bh * nch * 16);
  s.ctx = next(s.ctxp, nch * b * c * 8);
  s.hid = next(s.ctx, b * c * elt);
  s.qkv = next(s.hid, b * f * elt);
  s.qx = next(s.qkv, b * 3 * c * 4);
  s.lg = next(s.qx, b * c * 4);
  s.cnt = next(s.lg, bh * std::max(t_cap, t_mem) * 4);
  s.bytes = next(s.cnt, static_cast<long long>(n_layers) * 4 * bh * 4);
  return s;
}

template <typename T>
cudaError_t configure(int dev, size_t smem, int grid) {
  // A synthesis launches one device and size every frame: the attribute
  // and occupancy calls run when either changes.
  static std::mutex mu;
  static int cached_dev = -1;
  static size_t cached_smem = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (dev == cached_dev && smem == cached_smem) return cudaSuccess;
  auto kernel = decoder_step_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return e;
  // every block must be resident at once for the grid barriers
  if (per_sm < 1 || grid > sms * per_sm) return cudaErrorCooperativeLaunchTooLarge;
  cached_dev = dev;
  cached_smem = smem;
  return cudaSuccess;
}

template <typename T>
int run(const void* x, int step, const void* lns, const void* tiles,
        const void* cache_k, const void* cache_v, const void* mem_k,
        const void* mem_v, const void* mem_bias, void* x_out, void* align,
        void* k_new, void* v_new, void* scratch, void* bar,
        const void* sched_off, const void* sched, void* trace, int n_layers,
        int batch, int t_cap, int t_mem, int channels, int ffn,
        int num_heads, int grid, cudaStream_t stream) {
  constexpr int V = Tile<T>::kVec;
  if (num_heads < 1 || channels % num_heads || batch < 1 || n_layers < 1 ||
      step < 0 || step >= t_cap || t_mem < 1 || grid < 1 || ffn % V)
    return static_cast<int>(cudaErrorInvalidValue);
  const int head_dim = channels / num_heads;
  if (head_dim % V || head_dim / V > kConsumers ||
      2 * channels * static_cast<int>(sizeof(float)) > kSlotBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh = shape_of(sizeof(T), channels, ffn, head_dim);
  if (sh.n_slots == 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = configure<T>(dev, sh.smem, grid)) != cudaSuccess)
    return static_cast<int>(e);
  const Scratch sc = scratch_of(sizeof(T), n_layers, batch, channels, ffn,
                                num_heads,
                                t_cap, t_mem, grid);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Params<T> p;
  p.x = static_cast<const float*>(x);
  p.lns = static_cast<const float*>(lns);
  p.tiles = static_cast<const T*>(tiles);
  p.cache_k = static_cast<const T*>(cache_k);
  p.cache_v = static_cast<const T*>(cache_v);
  p.mem_k = static_cast<const T*>(mem_k);
  p.mem_v = static_cast<const T*>(mem_v);
  p.mem_bias = static_cast<const float*>(mem_bias);
  p.x_out = static_cast<float*>(x_out);
  p.align = static_cast<float*>(align);
  p.k_new = static_cast<T*>(k_new);
  p.v_new = static_cast<T*>(v_new);
  p.ex = reinterpret_cast<float4*>(base + sc.ex);
  p.qkv = reinterpret_cast<float*>(base + sc.qkv);
  p.qx = reinterpret_cast<float*>(base + sc.qx);
  p.hid = reinterpret_cast<T*>(base + sc.hid);
  p.ctx = reinterpret_cast<T*>(base + sc.ctx);
  p.ctxp = reinterpret_cast<double*>(base + sc.ctxp);
  p.lg = reinterpret_cast<float*>(base + sc.lg);
  p.cnt = reinterpret_cast<unsigned*>(base + sc.cnt);
  p.bar = static_cast<unsigned long long*>(bar);
  p.sched_off = static_cast<const int*>(sched_off);
  p.sched = static_cast<const int*>(sched);
  p.trace = static_cast<unsigned long long*>(trace);
  p.layer_elems = sh.layer_elems;
  for (int i = 0; i < kStages; ++i) {
    p.stage_off[i] = sh.stage_off[i];
    p.stage_k[i] = sh.stage_k[i];
    p.stage_n[i] = sh.stage_n[i];
  }
  p.step = step;
  p.n_layers = n_layers;
  p.batch = batch;
  p.t_cap = t_cap;
  p.t_mem = t_mem;
  p.c = channels;
  p.heads = num_heads;
  p.head_dim = head_dim;
  p.lg_len = std::max(t_cap, t_mem);
  p.n_slots = sh.n_slots;
  p.act_ld = sh.act_ld;
  p.scale = static_cast<float>(pow(static_cast<double>(head_dim), -0.5));
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decoder_step_kernel<T>), dim3(grid),
      dim3(kThreads), args, sh.smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tiles, caches, memory, k_new/v_new).
// x [B, C], lns [L, 6, C], mem_bias [B, Tm], x_out [B, C] and align [L, B,
// Tm, H] are float32; tiles [L, decoder_step_layer_elems] is the tiled
// layout of w_qkv [C, 3C], w_out / w_q / w_xout [C, C], w_ffn1 [C, F] and
// w_ffn2 [F, C] (ops/decode.py pack_decoder_weights); caches [L, B, Tcap, C]
// hold positions < step; memory [L, B, Tm, C].  scratch holds
// decoder_step_scratch_bytes; bar is one uint64 that starts at zero and
// carries over between launches (one frame at a time on it); sched_off
// [grid + 1] and sched are the int32 schedule of ops/decode.py
// decoder_schedule for this grid.  Every tensor is contiguous and 16-byte
// aligned.  Head dims are a multiple of 16 bytes with a row of at most 4 KB
// (one 16-byte vector per consumer thread); 0 <= step < Tcap.  trace, when not null, gets 8L + 2 global-timer
// stamps (ns): the start, the end of the set-up, then the end of each
// layer's eight stages as block 0 sees them.
extern "C" int decoder_step(int dtype, const void* x, int step,
                            const void* lns, const void* tiles,
                            const void* cache_k, const void* cache_v,
                            const void* mem_k, const void* mem_v,
                            const void* mem_bias, void* x_out, void* align,
                            void* k_new, void* v_new, void* scratch,
                            void* bar, const void* sched_off,
                            const void* sched, void* trace, int n_layers,
                            int batch, int t_cap, int t_mem, int channels,
                            int ffn, int num_heads, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODER_STEP_ARGS                                                    \
  x, step, lns, tiles, cache_k, cache_v, mem_k, mem_v, mem_bias, x_out,     \
      align, k_new, v_new, scratch, bar, sched_off, sched, trace, n_layers, \
      batch, t_cap, t_mem, channels, ffn, num_heads, grid, s
  if (dtype == 0) return run<float>(DECODER_STEP_ARGS);
  if (dtype == 1) return run<__nv_bfloat16>(DECODER_STEP_ARGS);
#undef DECODER_STEP_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" long long decoder_step_scratch_bytes(int elt, int n_layers,
                                                int batch, int channels,
                                                int ffn, int num_heads,
                                                int t_cap, int t_mem,
                                                int grid) {
  return scratch_of(elt, n_layers, batch, channels, ffn, num_heads, t_cap,
                    t_mem, grid)
      .bytes;
}

// The launch's dynamic shared memory for element size elt, or 0 when fewer
// than two ring slots fit beside the staged activations (C or F too wide).
extern "C" long long decoder_step_smem_bytes(int elt, int channels, int ffn,
                                             int head_dim) {
  const Shape s = shape_of(elt, channels, ffn, head_dim);
  return s.n_slots ? static_cast<long long>(s.smem) : 0;
}

extern "C" const char* decoder_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
