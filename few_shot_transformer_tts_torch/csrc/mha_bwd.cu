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
// Bound.  Reads q, k, v, o, do, lse (and bias) once and writes dq, dk, dv:
// at the decoder's causal shape (B=16, T=448, C=768, bf16) about 88 MB, 26 us
// at 3.35 TB/s, against five products (s, do.v^T, dv, dq, dk) over the
// causal half = 12.4 GFLOP, 12.5 us at 989 TFLOP/s -- bytes bound it.
//
// Design.  The TPU kernel keeps the whole K in VMEM and accumulates dk/dv in
// its output block across sequential q tiles; Hopper blocks run in parallel
// and in no order, so two kernels split the work with no atomics (the sums
// are deterministic: the same inputs give the same bits), each recomputing
// S and P (seven products instead of five):
//   * dq: grid (H, B, ceil(Tq/64)), the forward's layout.  A block owns 64
//     query rows (4 warps of 16), computes delta for them (and writes it for
//     the second kernel), then streams 64-key tiles of K/V (causal: up to
//     its last visible key).
//   * dk/dv: grid (H, B, ceil(Tk/64)).  A block owns 64 keys (4 warps of
//     16) and streams 64-query tiles of q, do, lse and delta (causal: from
//     its own first key on), with dk and dv in fp32 registers.
// bf16 (mha_bwd_dq_tc, mha_bwd_dkdv_tc) runs every product on the tensor
// cores (mma.sync m16n8k16, tensor_core.cuh) from shared-memory tiles that
// a two-stage 16-byte cp.async ring fills one tile ahead; the score, dP and
// ds rectangles live in accumulator fragments, and g and dss, rounded to
// bf16 at the TPU kernel's points, become the A operands of the dq, dv and
// dk products in registers.  The dk/dv kernel holds its rectangles
// transposed (keys down, queries across), so its lanes draw the Philox
// blocks of the keys they hold and trade words in pairs of lanes
// (philox::tile_drop_bits_t); both kernels draw a tile's mask while its
// copy is in flight.
// fp32 keeps the scalar kernels (mha_bwd_dq_fp32, mha_bwd_dkdv_fp32; the
// tensor cores would need TF32): 32-row blocks and tiles, FMA from shared
// memory.
//
// Head dims.  One library per head dim D (nvcc -DHEAD_DIM=<D>, D a multiple
// of 32 from 32 to 256; ops/cuda_build.py).  The bf16 kernels' registers
// and shared memory grow with D, so BwdShape<D> picks, per D:
//   * the streamed tile kT: 64 rows up to D = 192, 32 above.  A 32-row
//     tile halves the score and dP rectangles (32 registers each, not 64)
//     and the ring: the dk/dv kernel's (2 * 64 + 6 * kT) rows of D + 8
//     bf16 are 206 KB at D = 192 and would pass the 227 KB a block can
//     have at D = 224;
//   * the dk/dv kernel's output columns DC: all D up to D = 96, D / 2
//     above.  dk and dv of 16 keys x DC per warp take DC registers (at
//     D = 96 already 238-243 registers in all): a key block runs as two
//     blocks, grid z = key blocks x 2, each recomputing S and dP at full D
//     and accumulating its half of the columns.
// So no instantiation holds more accumulators than D = 96's: dq D/2 + 2 kT
// (at most 160), dk/dv DC + 2 kT (at most 160).  D = 64 and 96 keep their
// code (kT = 64, DC = D).
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
#include "tensor_core.cuh"

#ifndef HEAD_DIM
#error "build with -DHEAD_DIM=<head dim>: one library per head dim"
#endif
static_assert(HEAD_DIM % 32 == 0 && HEAD_DIM >= 32 && HEAD_DIM <= 256,
              "HEAD_DIM must be a multiple of 32 from 32 to 256");

namespace {

constexpr float kNegInf = -1e20f;
constexpr unsigned kFull = 0xffffffffu;

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
  int tq, tk, num_heads, head_offset;
  long long q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, o_sb, o_sr, do_sb, do_sr;
  float scale;
  int causal, use_bias;
  unsigned threshold;
  float inv_keep;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps of 16 rows
constexpr int kTcBlock = 64;     // rows a block owns (queries or keys)

// the streamed tile (keys for dq, queries for dk/dv) and the dk/dv
// kernel's output columns per block, by head dim (see the head-dim note)
template <int D>
struct BwdShape {
  static constexpr int kT = D <= 192 ? 64 : 32;
  static constexpr int kDC = D <= 96 ? D : D / 2;
  static constexpr int kSplit = D / kDC;
};

template <int D, int kT>
constexpr int dq_tc_smem_bytes() {
  // qs, do [64][D+8]; k and v in two stages [2][2][kT][D+8]; bias [2][kT];
  // delta [64]
  return (2 * kTcBlock + 4 * kT) * (D + 8) * 2 + (2 * kT + kTcBlock) * 4;
}

template <int D, int kT>
constexpr int dkdv_tc_smem_bytes() {
  // k, v [64][D+8]; q and do in two stages [2][2][kT][D+8]; qs and do/keep
  // [2][kT][D+8]; lse and delta in two stages [2][2][kT]
  return (2 * kTcBlock + 6 * kT) * (D + 8) * 2 + 4 * kT * 4;
}

// dq (and delta): a block owns 64 query rows of one (batch, head) and
// streams tiles of kT keys
template <int D, int kT, bool kDropout>
__global__ void __launch_bounds__(kTcThreads) mha_bwd_dq_tc(Args a) {
  constexpr int S = D + 8;
  constexpr int kChunks = D / 8;
  constexpr int kSteps = D / 16;
  constexpr int kTiles = D / 8;
  constexpr int kJ = kT / 8;  // 8-key column tiles of a key tile
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* do_s = qs_s + kTcBlock * S;
  bf16* kv_s = do_s + kTcBlock * S;  // stage st: k at st*2*kT*S, v after it
  float* bias_s = reinterpret_cast<float*>(kv_s + 4 * kT * S);
  float* delta_s = bias_s + 2 * kT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // grid (H, B, row blocks), the last rows (causal: the longest) first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBlock;
  const int tq = a.tq, tk = a.tk, H = a.num_heads;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * D;
  const bf16* ob = static_cast<const bf16*>(a.o) + b * a.o_sb + h * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * D;
  const float* biasb = a.bias + static_cast<long long>(b) * tk;
  const int k_end = a.causal ? min(tk, q0 + kTcBlock) : tk;
  const int n_tiles = (k_end + kT - 1) / kT;

  auto load_tile = [&](int k0, int st) {
    bf16* ks = kv_s + st * 2 * kT * S;
    bf16* vs = ks + kT * S;
    for (int c = tid; c < kT * kChunks; c += kTcThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8, kj = k0 + r;
      const bool in = kj < tk;
      const long long row = in ? kj : 0;
      tc::cp_async16(ks + r * S + col, kb + row * a.k_sr + col, in);
      tc::cp_async16(vs + r * S + col, vb + row * a.v_sr + col, in);
    }
    if (a.use_bias && tid < kT) {
      const int kj = k0 + tid;
      tc::cp_async4(bias_s + st * kT + tid, biasb + (kj < tk ? kj : 0),
                    kj < tk);
    }
    tc::cp_async_commit();
  };
  load_tile(0, 0);

  // q (scaled and rounded) and do into shared memory, and delta =
  // rowsum(do . o) in fp32: two threads per row, each over half of its
  // 16-byte chunks, every load issued before the sums need it
  static_assert(kTcThreads == 2 * kTcBlock && kChunks % 2 == 0,
                "two threads per row");
  {
    const int r = tid >> 1, c0 = (tid & 1) * (kChunks / 2), qi = q0 + r;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks / 2; ++i) {
      const int col = (c0 + i) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
      if (qi < tq) {
        x = tc::scale_bf16x8(
            *reinterpret_cast<const uint4*>(qb + qi * a.q_sr + col), a.scale);
        y = *reinterpret_cast<const uint4*>(dob + qi * a.do_sr + col);
        part += tc::dot_bf16x8(
            y, *reinterpret_cast<const uint4*>(ob + qi * a.o_sr + col));
      }
      *reinterpret_cast<uint4*>(qs_s + r * S + col) = x;
      *reinterpret_cast<uint4*>(do_s + r * S + col) = y;
    }
    part += __shfl_xor_sync(kFull, part, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = part;
      if (qi < tq)
        a.delta[(static_cast<long long>(b) * tq + qi) * H + h] = part;
    }
  }
  __syncthreads();
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float dl[2], ls[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    dl[r] = delta_s[warp * 16 + g + 8 * r];
    ls[r] = qi < tq ? a.lse[(static_cast<long long>(b) * tq + qi) * H + h]
                    : 0.f;
  }
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  float acc[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kT, st = it & 1;
    if (it + 1 < n_tiles) load_tile(k0 + kT, st ^ 1);
    unsigned drop = 0;  // the tile's mask, drawn while the copies fly
    if (kDropout)
      drop = philox::tile_drop_bits<kJ>(sd, k0, row0, h + a.head_offset, b,
                                        a.threshold, t);
    if (it + 1 < n_tiles) {
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv_s + st * 2 * kT * S;
    const bf16* vs = ks + kT * S;

    // S = qs . k^T and dP = do . v^T
    float s[kJ][4], dp[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa[4], da[4];
      tc::ldmatrix_x4(qa, tc::a_rows<S>(qs_s, warp * 16, kk * 16, lane));
      tc::ldmatrix_x4(da, tc::a_rows<S>(do_s, warp * 16, kk * 16, lane));
#pragma unroll
      for (int jj = 0; jj < kJ / 2; ++jj) {
        uint32_t kf[4], vf[4];
        tc::ldmatrix_x4(kf, tc::b_rows<S>(ks, jj * 16, kk * 16, lane));
        tc::ldmatrix_x4(vf, tc::b_rows<S>(vs, jj * 16, kk * 16, lane));
        tc::mma_bf16(s[2 * jj], qa, kf[0], kf[1]);
        tc::mma_bf16(s[2 * jj + 1], qa, kf[2], kf[3]);
        tc::mma_bf16(dp[2 * jj], da, vf[0], vf[1]);
        tc::mma_bf16(dp[2 * jj + 1], da, vf[2], vf[3]);
      }
    }

    // dss = round(p * (dw - delta) * scale), left in s
    const bool edge = (a.causal && k0 + kT > q0) || k0 + kT > tk;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        if (a.use_bias) x += bias_s[st * kT + kc];
        if (edge) {
          const int kj = k0 + kc;
          if (a.causal && kj > row0 + 8 * (e >> 1)) x = kNegInf;
          if (kj >= tk) x = -INFINITY;
        }
        const float p = expf(x - ls[e >> 1]);
        float dw = dp[j][e];
        if (kDropout)
          dw = (drop >> (4 * j + e)) & 1u ? 0.f : __fmul_rn(dw, a.inv_keep);
        s[j][e] = p * (dw - dl[e >> 1]) * a.scale;
      }
    }

    // dq += dss . k
#pragma unroll
    for (int kk = 0; kk < kJ / 2; ++kk) {
      uint32_t sa[4];
      tc::acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t kf[4];
        tc::ldmatrix_x4_trans(kf, tc::bt_rows<S>(ks, kk * 16, dd * 16, lane));
        tc::mma_bf16(acc[2 * dd], sa, kf[0], kf[1]);
        tc::mma_bf16(acc[2 * dd + 1], sa, kf[2], kf[3]);
      }
    }
    __syncthreads();
  }

  // dq through this warp's rows of qs_s (read by this warp only)
  bf16* o_s = qs_s + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    *reinterpret_cast<uint32_t*>(o_s + g * S + 8 * n + 2 * t) =
        tc::pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * S + 8 * n + 2 * t) =
        tc::pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  bf16* dqb = static_cast<bf16*>(a.dq);
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < tq)
      *reinterpret_cast<uint4*>(dqb + (static_cast<long long>(b) * tq + qi) *
                                          (H * D) + h * D + col) =
          *reinterpret_cast<const uint4*>(o_s + r * S + col);
  }
}

// dk and dv: a block owns 64 keys of one (batch, head), and of their dk and
// dv the DC columns from c0, and streams tiles of kT queries; rectangles
// are held transposed, keys down and queries across.  A warp's 16 keys sit
// in its rows of k_s and v_s in the order 0, 2, .., 14, 1, 3, .., 15, so
// that the mma rows g and g + 8 of lane 4g + t are the neighbouring keys
// 2g, 2g + 1 and a Philox block (4 keys) is shared by two lanes, not four.
template <int D, int DC, int kT, bool kDropout>
__global__ void __launch_bounds__(kTcThreads) mha_bwd_dkdv_tc(Args a) {
  constexpr int S = D + 8;
  constexpr int kChunks = D / 8;
  constexpr int kSteps = D / 16;
  constexpr int kTiles = DC / 8;  // n-tiles of this block's columns
  constexpr int kSplit = D / DC;
  constexpr int kJ = kT / 8;      // 8-query column tiles of a query tile
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* v_s = k_s + kTcBlock * S;
  bf16* ring_s = v_s + kTcBlock * S;  // stage st: q at st*2*kT*S, do after
  bf16* qs_s = ring_s + 4 * kT * S;   // round(q * scale)
  bf16* dok_s = qs_s + kT * S;        // round(do / keep)
  float* stat_s = reinterpret_cast<float*>(dok_s + kT * S);  // [2][lse, delta]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // grid (H, B, key blocks x column splits): causal blocks of the first
  // keys, the longest, start first
  const int k0 = (blockIdx.z / kSplit) * kTcBlock, h = blockIdx.x,
            b = blockIdx.y;
  const int c0 = (blockIdx.z % kSplit) * DC;
  const int tq = a.tq, tk = a.tk, H = a.num_heads;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * D;
  const long long stat0 = static_cast<long long>(b) * tq;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = (tq - q_begin + kT - 1) / kT;

  // the block's K and V rows (zero beyond Tk), key 16w + i at row
  // 16w + i/2 + 8(i%2), join the first tile's group
  for (int c = tid; c < kTcBlock * kChunks; c += kTcThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8, kj = k0 + r;
    const int m = (r & ~15) | ((r & 15) >> 1) | ((r & 1) << 3);
    const bool in = kj < tk;
    const long long row = in ? kj : 0;
    tc::cp_async16(k_s + m * S + col, kb + row * a.k_sr + col, in);
    tc::cp_async16(v_s + m * S + col, vb + row * a.v_sr + col, in);
  }
  auto load_tile = [&](int q0, int st) {
    bf16* qr = ring_s + st * 2 * kT * S;
    bf16* dr = qr + kT * S;
    for (int c = tid; c < kT * kChunks; c += kTcThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8, qi = q0 + r;
      const bool in = qi < tq;
      const long long row = in ? qi : 0;
      tc::cp_async16(qr + r * S + col, qb + row * a.q_sr + col, in);
      tc::cp_async16(dr + r * S + col, dob + row * a.do_sr + col, in);
    }
    // threads 0..kT-1 copy lse, kT..2kT-1 delta, of one query each
    if (tid < 2 * kT) {
      const int qi = q0 + tid % kT;
      const bool in = qi < tq;
      const float* src = tid < kT ? a.lse : a.delta;
      tc::cp_async4(stat_s + st * 2 * kT + tid,
                    src + (stat0 + (in ? qi : 0)) * H + h, in);
    }
    tc::cp_async_commit();
  };
  load_tile(q_begin, 0);

  const int key0 = k0 + warp * 16 + 2 * g;  // this lane's keys: key0, +1
  float bias_k[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + r;
    bias_k[r] = (a.use_bias && kj < tk)
                    ? a.bias[static_cast<long long>(b) * tk + kj]
                    : 0.f;
  }
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  float dk[kTiles][4], dv[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * kT, st = it & 1;
    if (it + 1 < n_tiles) load_tile(q0 + kT, st ^ 1);
    unsigned drop = 0;  // the tile's mask, drawn while the copies fly
    if (kDropout)
      drop = philox::tile_drop_bits_t<kJ>(sd, key0, q0, h + a.head_offset, b,
                                          a.threshold, g, t);
    if (it + 1 < n_tiles) {
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    const bf16* qr = ring_s + st * 2 * kT * S;
    const bf16* dr = qr + kT * S;
    // each thread scales the chunks its own copies brought in: q * scale
    // (and do / keep) rounded to bf16, the TPU kernel's operands
    for (int c = tid; c < kT * kChunks; c += kTcThreads) {
      const int off = (c / kChunks) * S + (c % kChunks) * 8;
      *reinterpret_cast<uint4*>(qs_s + off) = tc::scale_bf16x8(
          *reinterpret_cast<const uint4*>(qr + off), a.scale);
      if (kDropout)
        *reinterpret_cast<uint4*>(dok_s + off) = tc::scale_bf16x8(
            *reinterpret_cast<const uint4*>(dr + off), a.inv_keep);
    }
    __syncthreads();
    const float* lse_t = stat_s + st * 2 * kT;
    const float* delta_t = lse_t + kT;

    // S^T = k . qs^T and dP^T = v . do^T (keys down, queries across), at
    // full D whatever columns this block owns
    float s[kJ][4], dp[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t ka[4], va[4];
      tc::ldmatrix_x4(ka, tc::a_rows<S>(k_s, warp * 16, kk * 16, lane));
      tc::ldmatrix_x4(va, tc::a_rows<S>(v_s, warp * 16, kk * 16, lane));
#pragma unroll
      for (int jj = 0; jj < kJ / 2; ++jj) {
        uint32_t qf[4], df[4];
        tc::ldmatrix_x4(qf, tc::b_rows<S>(qs_s, jj * 16, kk * 16, lane));
        tc::ldmatrix_x4(df, tc::b_rows<S>(dr, jj * 16, kk * 16, lane));
        tc::mma_bf16(s[2 * jj], ka, qf[0], qf[1]);
        tc::mma_bf16(s[2 * jj + 1], ka, qf[2], qf[3]);
        tc::mma_bf16(dp[2 * jj], va, df[0], df[1]);
        tc::mma_bf16(dp[2 * jj + 1], va, df[2], df[3]);
      }
    }

    // g = keep ? p : 0 (left in s) and dss (left in dp)
    const bool edge = (a.causal && q0 < k0 + kTcBlock) ||
                      q0 + kT > tq || k0 + kTcBlock > tk;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const int kj = key0 + (e >> 1);
        float x = s[j][e] + bias_k[e >> 1];
        if (edge) {
          if (a.causal && kj > q0 + qc) x = kNegInf;
          if (kj >= tk) x = -INFINITY;
        }
        float p = expf(x - lse_t[qc]);
        if (edge && q0 + qc >= tq) p = 0.f;
        float dw = dp[j][e];
        float gv = p;
        if (kDropout) {
          const bool dropped = (drop >> (4 * j + e)) & 1u;
          gv = dropped ? 0.f : p;
          dw = dropped ? 0.f : __fmul_rn(dw, a.inv_keep);
        }
        s[j][e] = gv;
        dp[j][e] = p * (dw - delta_t[qc]) * a.scale;
      }
    }

    // dv += round(g) . round(do / keep), dk += dss . q_raw, over this
    // block's columns
    const bf16* dv_b = kDropout ? dok_s : dr;
#pragma unroll
    for (int kk = 0; kk < kJ / 2; ++kk) {
      uint32_t ga[4], sa[4];
      tc::acc_to_a(ga, s[2 * kk], s[2 * kk + 1]);
      tc::acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < DC / 16; ++dd) {
        uint32_t of[4], qf[4];
        tc::ldmatrix_x4_trans(
            of, tc::bt_rows<S>(dv_b, kk * 16, c0 + dd * 16, lane));
        tc::ldmatrix_x4_trans(
            qf, tc::bt_rows<S>(qr, kk * 16, c0 + dd * 16, lane));
        tc::mma_bf16(dv[2 * dd], ga, of[0], of[1]);
        tc::mma_bf16(dv[2 * dd + 1], ga, of[2], of[3]);
        tc::mma_bf16(dk[2 * dd], sa, qf[0], qf[1]);
        tc::mma_bf16(dk[2 * dd + 1], sa, qf[2], qf[3]);
      }
    }
    __syncthreads();  // the stage and the scaled tiles are consumed
  }

  // dk and dv (this block's columns) through this warp's rows of k_s and
  // v_s (read by this warp only), now in key order, to 16-byte stores
  bf16* dk_s = k_s + warp * 16 * S;
  bf16* dv_s = v_s + warp * 16 * S;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    const int off0 = 2 * g * S + 8 * n + 2 * t, off1 = off0 + S;
    *reinterpret_cast<uint32_t*>(dk_s + off0) = tc::pack_bf16(dk[n][0], dk[n][1]);
    *reinterpret_cast<uint32_t*>(dk_s + off1) = tc::pack_bf16(dk[n][2], dk[n][3]);
    *reinterpret_cast<uint32_t*>(dv_s + off0) = tc::pack_bf16(dv[n][0], dv[n][1]);
    *reinterpret_cast<uint32_t*>(dv_s + off1) = tc::pack_bf16(dv[n][2], dv[n][3]);
  }
  __syncwarp();
  bf16* dkb = static_cast<bf16*>(a.dk);
  bf16* dvb = static_cast<bf16*>(a.dv);
  constexpr int kChunksC = DC / 8;
  for (int c = lane; c < 16 * kChunksC; c += 32) {
    const int r = c / kChunksC, col = (c % kChunksC) * 8;
    const int kj = k0 + warp * 16 + r;
    if (kj >= tk) continue;
    const long long off =
        (static_cast<long long>(b) * tk + kj) * (H * D) + h * D + c0 + col;
    *reinterpret_cast<uint4*>(dkb + off) =
        *reinterpret_cast<const uint4*>(dk_s + r * S + col);
    *reinterpret_cast<uint4*>(dvb + off) =
        *reinterpret_cast<const uint4*>(dv_s + r * S + col);
  }
}

template <int D, bool kDropout>
cudaError_t launch_tc(const Args& a, int batch, cudaStream_t stream) {
  using Sh = BwdShape<D>;
  constexpr int kDqSmem = dq_tc_smem_bytes<D, Sh::kT>();
  constexpr int kDkvSmem = dkdv_tc_smem_bytes<D, Sh::kT>();
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
                "a block takes at most 227 KB of shared memory");
  auto* dq_kernel = mha_bwd_dq_tc<D, Sh::kT, kDropout>;
  auto* dkdv_kernel = mha_bwd_dkdv_tc<D, Sh::kDC, Sh::kT, kDropout>;
  // dynamic shared memory above 48 KB needs the opt-in, once per kernel
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dkdv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDkvSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid_q(a.num_heads, batch, (a.tq + kTcBlock - 1) / kTcBlock);
  dq_kernel<<<grid_q, kTcThreads, kDqSmem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k(a.num_heads, batch,
                    (a.tk + kTcBlock - 1) / kTcBlock * Sh::kSplit);
  dkdv_kernel<<<grid_k, kTcThreads, kDkvSmem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlock = kWarps * kRowsPerWarp;  // rows (queries or keys)
constexpr int kTile = 32;                      // streamed tile (keys or queries)

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

// dq (and delta): a block owns 32 query rows of one (batch, head)
template <int D, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_bwd_dq_fp32(Args a) {
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
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * D;
  const float* ob = static_cast<const float*>(a.o) + b * a.o_sb + h * D;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  for (int idx = tid; idx < kBlock * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D, qi = q0 + r;
    const bool in = qi < tq;
    qs_s[r][c] = in ? qb[qi * a.q_sr + c] * a.scale : 0.f;
    do_s[r][c] = in ? dob[qi * a.do_sr + c] : 0.f;
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
        part += do_s[r][lane + 32 * d] * ob[qi * a.o_sr + lane + 32 * d];
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
      k_s[r][c] = in ? kb[kj * a.k_sr + c] : 0.f;
      v_s[r][c] = in ? vb[kj * a.v_sr + c] : 0.f;
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
                                  q0 + warp * kRowsPerWarp + (lane >> 3),
                                  h + a.head_offset, b);

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
        const uint4 w = make_uint4(__shfl_sync(kFull, bits.x, src),
                                   __shfl_sync(kFull, bits.y, src),
                                   __shfl_sync(kFull, bits.z, src),
                                   __shfl_sync(kFull, bits.w, src));
        dw = philox::word(w, lane & 3) >= a.threshold ? dw * a.inv_keep : 0.f;
      }
      ds_s[warp][i][lane] = p * (dw - delta[i]) * a.scale;
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

  float* dqb = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    float* row = dqb + ((long long)b * tq + qi) * (H * D) + h * D;
#pragma unroll
    for (int d = 0; d < kDims; ++d) row[lane + 32 * d] = acc[i][d];
  }
}

// dk and dv: a block owns 32 keys of one (batch, head)
template <int D, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_bwd_dkdv_fp32(Args a) {
  constexpr int kDims = D / 32;
  extern __shared__ float smem[];
  float(*k_s)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*v_s)[D] = k_s + kBlock;
  float(*qr_s)[D] = v_s + kBlock;   // raw q (for dk)
  float(*dok_s)[D] = qr_s + kTile;  // do / keep (for dv)
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
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * D;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  for (int idx = tid; idx < kBlock * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - r * D, kj = k0 + r;
    const bool in = kj < tk;
    k_s[r][c] = in ? kb[kj * a.k_sr + c] : 0.f;
    v_s[r][c] = in ? vb[kj * a.v_sr + c] : 0.f;
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
      const float qv = in ? qb[qi * a.q_sr + c] : 0.f;
      const float dov = in ? dob[qi * a.do_sr + c] : 0.f;
      qr_s[r][c] = qv;
      qs_s[r][c] = qv * a.scale;
      do_s[r][c] = dov;
      dok_s[r][c] = dov * a.inv_keep;
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
    if (kDropout)
      bits = philox::dropout_bits(sd, key0 >> 2, qj, h + a.head_offset, b);

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
      g_s[warp][i][lane] = g;
      ds_s[warp][i][lane] = p * (dw - delta_s[lane]) * a.scale;
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

  float* dkb = static_cast<float*>(a.dk);
  float* dvb = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int kj = key0 + i;
    if (kj >= tk) continue;
    const long long off = ((long long)b * tk + kj) * (H * D) + h * D;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      dkb[off + lane + 32 * d] = dk[i][d];
      dvb[off + lane + 32 * d] = dv[i][d];
    }
  }
}

template <int D, bool kDropout>
cudaError_t launch_fp32(const Args& a, int batch, cudaStream_t stream) {
  // dynamic shared memory above 48 KB needs the opt-in, once per kernel
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        mha_bwd_dq_fp32<D, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(mha_bwd_dkdv_fp32<D, kDropout>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkdv_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid_q((a.tq + kBlock - 1) / kBlock, a.num_heads, batch);
  mha_bwd_dq_fp32<D, kDropout>
      <<<grid_q, kWarps * 32, dq_smem_bytes<D>(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.tk + kBlock - 1) / kBlock, a.num_heads, batch);
  mha_bwd_dkdv_fp32<D, kDropout>
      <<<grid_k, kWarps * 32, dkdv_smem_bytes<D>(), stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int dtype, bool dropout, const Args& a, int batch,
                     cudaStream_t s) {
  if (dtype == 1)
    return dropout ? launch_tc<D, true>(a, batch, s)
                   : launch_tc<D, false>(a, batch, s);
  return dropout ? launch_fp32<D, true>(a, batch, s)
                 : launch_fp32<D, false>(a, batch, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: HEAD_DIM, the one this
// library was built for (any other is refused).  Strides are in
// elements; the last dim of q, k, v, o and dout must be contiguous, and for
// bfloat16 the base addresses and the batch and row strides of q, k, v, o
// and dout must be multiples of 16 bytes.  bias [B, Tk] float32 (ignored unless
// use_bias); seed one int64 on the device (read only when dropout != 0);
// lse [B, Tq, H] float32 from the forward.  dq [B, Tq, H*D], dk and dv
// [B, Tk, H*D] in the input type and delta [B, Tq, H] float32 (workspace)
// are contiguous outputs.  inv_keep is float(1 / (1 - rate)); head_offset
// as in mha_fwd.
extern "C" int mha_bwd(int dtype, int head_dim, const void* q, const void* k,
                       const void* v, const void* bias, const void* seed,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* delta, int batch,
                       int tq, int tk, int num_heads, int head_offset,
                       long long q_sb, long long q_sr, long long k_sb,
                       long long k_sr,
                       long long v_sb, long long v_sr, long long o_sb,
                       long long o_sr, long long do_sb, long long do_sr,
                       float scale, int causal, int use_bias, int dropout,
                       unsigned threshold, float inv_keep, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,  k,  v,  static_cast<const float*>(bias),
         static_cast<const long long*>(seed), o, static_cast<const float*>(lse),
         dout, dq, dk, dv, static_cast<float*>(delta),
         tq, tk, num_heads, head_offset, q_sb, q_sr, k_sb, k_sr, v_sb, v_sr,
         o_sb, o_sr, do_sb, do_sr, scale, causal, use_bias, threshold,
         inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<HEAD_DIM>(dtype, dropout != 0, a, batch, s);
}

extern "C" const char* mha_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
