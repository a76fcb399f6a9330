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
// C=768 (2 heads of 384, or 1 of 768) the forward must move the same 44 MB
// as at 8 heads of 96, 13 us at 3.35 TB/s, against 2.5 GFLOP of products
// (2.5 us at 989 TFLOP/s); the backward 88 MB, 26 us.
//
// The head dim is a run-time value (a multiple of 32 up to 1024; ops/mha.py
// pads any other), so one library serves every D above 256.
//
// bf16 design: the products on the tensor cores (mma.sync m16n8k16 with
// ldmatrix, tensor_core.cuh), every tile in shared memory filled by 16-byte
// cp.async, 64 rows a block in 4 warps of 16, as in mha_fwd.cu.  A row's
// D/2 output accumulators per lane do not fit in registers above D = 256,
// so a block that sums an output owns a slice of at most 256 columns (128
// fp32 accumulators per lane, what mha_fwd.cu holds at D = 256): n_col =
// ceil(D / 256) slices of equal width rounded up to 16 columns.  Summing a
// 64 x 64 score tile over D costs 2 x 64 x 64 x D products and the copies
// of 2 x 64 x D bf16, while the tile itself is 16 KB of fp32, so each score
// tile is computed once and kept in a workspace from the caller (the slices
// would otherwise recompute it: 2-4 times, most of the work), and every
// later product reads it back from L2.  Blocks that sum over D stream
// 64-wide chunks of their rows through a three-stage cp.async ring, two
// chunks ahead of the products (tile_products); q is scaled and rounded in
// its A fragments.
//   * Forward, two kernels: wide_scores_tc, grid (Tk tiles, Tq tiles, B x
//     H), one 64 x 64 tile each (causal: those on and below the diagonal):
//     S = round(q * scale).k^T with the bias and masks, stored in fp32 in
//     the order of its accumulator fragments, its row maxima, and with
//     dropout its mask (drawn once, not once per output slice);
//     wide_pv_tc, grid (H x n_col, B, Tq tiles): a row's final max from the
//     tiles' maxima, then per key tile p = exp(s - m) (so p rounds where
//     the reference rounds it: at the row's final max, not at a running
//     one), l, the dropout mask and round(p).V on the block's columns, the
//     V slice and the score tile streaming through a two-stage ring; the
//     warps own 16-column groups over all 64 rows (round(p) passes through
//     shared memory), so a V fragment serves four m-tiles.
//   * Backward: the TPU kernel rounds two T x T operands, g = keep ? p : 0
//     and ds * scale, to bf16.  They are materialised once in the bf16
//     workspace, and every gradient product reads them:
//       1. wide_delta: delta = rowsum(do . o) in fp32, one warp per row;
//       2. wide_ds_tc: grid (Tk tiles, Tq tiles, B x H): S and dP = do.v^T
//          of one tile, p = exp(s - lse), the mask, g and ds * scale
//          rounded and stored;
//       3. wide_grad_tc: grid (3 x n_col, row blocks, B x H), one 64-row
//          block of one output slice each: dq = dss.k (query blocks), dk =
//          dss^T.q (key blocks), dv = round(g)^T.round(do / keep) (key
//          blocks), over 64-row tiles of the workspace and of k, q or do in
//          a two-stage ring; the transposed operands come from the stored
//          tiles by ldmatrix.trans.
//     S and dP are computed once (the recompute-per-slice design of
//     mha_bwd.cu would compute them 2 x ceil(D / 128) times above D = 256),
//     the five products run at full tensor-core width, and no value is
//     summed with atomics: two calls give the same bits.
// Workspaces (ops/mha.py wide_workspace), Tq64 and Tk64 being Tq and Tk
// rounded up to 64: forward fp32 B * H * Tq64 * (Tk64 + 3 * Tk64 / 64),
// 26.9 MB at B=16, T=448, 2 heads; backward bf16 2 * B * H * Tq64 * Tk64,
// 25.7 MB there.  A causal call writes and reads the tiles on and below the
// diagonal only.
// fp32 keeps scalar kernels (the tensor cores would need TF32, which would
// change the reference's numerics): a block owns 32 rows (queries, or keys
// in the dk/dv kernel) and 128 output columns, grid y = heads x ceil(D /
// 128), streaming D in 128-wide chunks of 32-row tiles, FMA from shared
// memory; dq (and delta) by query blocks, dk/dv by key blocks.
//
// Interface: a plain C entry per direction, built once by nvcc into a
// shared library and loaded with ctypes (ops/cuda_build.py); the arguments
// are those of mha_fwd.cu and mha_bwd.cu with the workspace after lse
// (forward) or delta (backward).  Each launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e20f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 1024;

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
  void* ws;    // bf16 backward: round(g), then round(ds * scale)
  int tq, tk, num_heads, head_offset, head_dim;
  int n_col, col_w;  // output slices per head, and their width
  long long q_sb, q_sr, k_sb, k_sr, v_sb, v_sr, o_sb, o_sr, do_sb, do_sr;
  float scale;
  int causal, use_bias;
  unsigned threshold;
  float keep;  // forward: 1 - rate; backward: 1 / (1 - rate)
};

// ===========================================================================
// bf16: tensor cores
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;  // 4 warps of 16 rows
constexpr int kRows = 64;        // rows a block owns, keys per tile
constexpr int kTileElems = kRows * kRows;
constexpr int kChunk = 64;       // D chunk of the score products
constexpr int kSC = kChunk + 8;  // row stride of a 64-wide tile (bf16)
constexpr int kSlice = 256;      // output columns a block owns at most
constexpr int kSV = kSlice + 8;  // row stride of a slice tile
constexpr int kStages = 3;       // ring stages of the score products

constexpr int kScoresSmem = kStages * 2 * kRows * kSC * 2 + kRows * 4;
// a PV stage: the V slice [64][kSV] bf16, the score tile (4096 fp32) and
// its dropout words (one per lane of the 4 warps)
constexpr int kPvStage = kRows * kSV * 2 + kTileElems * 4 + kTcThreads * 4;
// two stages, round(p) [64][kSC] bf16, 1 / l of the 64 rows
constexpr int kPvSmem = 2 * kPvStage + kRows * kSC * 2 + kRows * 4;
constexpr int kDsSmem = kStages * 4 * kRows * kSC * 2 + kRows * 4;
constexpr int kGradSmem = 2 * (kRows * kSC + kRows * kSV) * 2;

// Each element of four bf16 pairs times s in fp32, rounded back to bf16
// (q * scale before the dot).
__device__ __forceinline__ void scale_frag(uint32_t (&r)[4], float s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = tc::unpack_bf16(r[i]);
    r[i] = tc::pack_bf16(f.x * s, f.y * s);
  }
}

// The output-slice products (P.V, dq, dk, dv): a 64-row block of a slice
// of at most 256 columns, each warp owning the 16-column groups warp,
// warp + 4, .. (at most 4) over all 64 rows, so a B fragment serves four
// m-tiles and an A fragment four groups: acc[group][m-tile][8-column
// half][4], 128 fp32 per lane.
using SliceAcc = float[4][4][2][4];

__device__ __forceinline__ void zero_acc(SliceAcc& acc) {
#pragma unroll
  for (int gi = 0; gi < 4; ++gi)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nh = 0; nh < 2; ++nh)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][mt][nh][e] = 0.f;
}

// acc += A . B over 64 reduction rows: A [64 rows][64] in a_s (stride kSC;
// kTransA: stored transposed, reduction index down), B [64][slice] in b_s
// (stride kSV, reduction index down), n16 16-column groups in the slice.
template <bool kTransA>
__device__ __forceinline__ void slice_mma(SliceAcc& acc, const bf16* a_s,
                                          const bf16* b_s, int n16, int warp,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t af[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (kTransA)
        tc::ldmatrix_x4_trans(af[mt],
                              tc::b_rows<kSC>(a_s, kk * 16, mt * 16, lane));
      else
        tc::ldmatrix_x4(af[mt], tc::a_rows<kSC>(a_s, mt * 16, kk * 16, lane));
    }
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const int dd = warp + 4 * gi;
      if (dd < n16) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, tc::bt_rows<kSV>(b_s, kk * 16, dd * 16,
                                                   lane));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          tc::mma_bf16(acc[gi][mt][0], af[mt], bf[0], bf[1]);
          tc::mma_bf16(acc[gi][mt][1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
}

// The block's 64 x width outputs, each row times row_mul[row], rounded to
// bf16 through o_s ([64][kSV], free of copies) into rows r0.. (below
// n_rows) of out, columns col0.. (row stride out_sr): 16-byte stores.
__device__ __forceinline__ void store_slice(const SliceAcc& acc,
                                            const float* row_mul, bf16* o_s,
                                            bf16* out, long long out_sr,
                                            int r0, int n_rows, int width,
                                            int warp, int lane) {
  const int g = lane >> 2, t = lane & 3, n16 = width / 16;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r = mt * 16 + g;
    const float m0 = row_mul ? row_mul[r] : 1.f;
    const float m1 = row_mul ? row_mul[r + 8] : 1.f;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const int dd = warp + 4 * gi;
      if (dd < n16) {
#pragma unroll
        for (int nh = 0; nh < 2; ++nh) {
          const int col = dd * 16 + nh * 8 + 2 * t;
          const float* c = acc[gi][mt][nh];
          *reinterpret_cast<uint32_t*>(o_s + r * kSV + col) =
              tc::pack_bf16(c[0] * m0, c[1] * m0);
          *reinterpret_cast<uint32_t*>(o_s + (r + 8) * kSV + col) =
              tc::pack_bf16(c[2] * m1, c[3] * m1);
        }
      }
    }
  }
  __syncthreads();
  const int n8 = width / 8;
  for (int c = threadIdx.x; c < kRows * n8; c += kTcThreads) {
    const int r = c / n8, col = (c - r * n8) * 8;
    if (r0 + r < n_rows)
      *reinterpret_cast<uint4*>(out + (r0 + r) * out_sr + col) =
          *reinterpret_cast<const uint4*>(o_s + r * kSV + col);
  }
}

// Tiles of a (b, h) in the workspaces, 64 x 64 each: Tq and Tk rounded up
// to whole tiles.
__host__ __device__ __forceinline__ int n_tiles_of(int t) {
  return (t + kRows - 1) / kRows;
}

// S = round(q * scale) . k^T of the 64 x 64 tile at (q0, k0) of head h,
// and with kDp dP = do . v^T, into this lane's accumulator fragments: the
// D chunks of the tile's rows stream through a three-stage cp.async ring
// (ring stage st holds q, k and with kDp do, v, [64][kSC] each), two chunks
// ahead of the products; q is scaled and rounded in its A fragments.  The
// bias of the tile's keys lands in bias_s with the first chunk.  Returns
// with no copy in flight and the ring stage of chunk nc % 3 free.
template <bool kDp>
__device__ __forceinline__ void tile_products(const Args& a, int b, int h,
                                              int q0, int k0, bf16* ring,
                                              float* bias_s,
                                              float (&s)[8][4],
                                              float (&dp)[8][4]) {
  constexpr int kPer = kDp ? 4 : 2;  // tiles per ring stage
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = a.head_dim, tq = a.tq, tk = a.tk;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * D;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * D;
  const int nc = (D + kChunk - 1) / kChunk;

  // a group is committed even past the last chunk, so the wait count
  // below stays fixed
  auto load_chunk = [&](int c) {
    if (c < nc) {
      const int c0 = c * kChunk, n8 = min(kChunk, D - c0) / 8;
      bf16* qs = ring + (c % kStages) * kPer * kRows * kSC;
      bf16* ks = qs + kRows * kSC;
      for (int i = tid; i < kRows * 8; i += kTcThreads) {
        const int r = i >> 3, col = (i & 7) * 8;
        if (col < n8 * 8) {
          const int qi = q0 + r, kj = k0 + r;
          const long long qr = qi < tq ? qi : 0, kr = kj < tk ? kj : 0;
          tc::cp_async16(qs + r * kSC + col, qb + qr * a.q_sr + c0 + col,
                         qi < tq);
          tc::cp_async16(ks + r * kSC + col, kb + kr * a.k_sr + c0 + col,
                         kj < tk);
          if (kDp) {
            tc::cp_async16(ks + kRows * kSC + r * kSC + col,
                           dob + qr * a.do_sr + c0 + col, qi < tq);
            tc::cp_async16(ks + 2 * kRows * kSC + r * kSC + col,
                           vb + kr * a.v_sr + c0 + col, kj < tk);
          }
        }
      }
    }
    tc::cp_async_commit();
  };
  if (a.use_bias && tid < kRows) {  // joins chunk 0's group
    const int kj = k0 + tid;
    tc::cp_async4(bias_s + tid,
                  a.bias + static_cast<long long>(b) * tk + (kj < tk ? kj : 0),
                  kj < tk);
  }
  load_chunk(0);
  load_chunk(1);

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    tc::cp_async_wait<1>();  // committed after chunk c: chunk c + 1
    __syncthreads();         // chunk c is visible, chunk c - 1 consumed
    load_chunk(c + 2);
    const bf16* qs = ring + (c % kStages) * kPer * kRows * kSC;
    const bf16* ks = qs + kRows * kSC;
    const int steps = min(kChunk, D - c * kChunk) / 16;
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      if (kk < steps) {
        uint32_t qa[4];
        tc::ldmatrix_x4(qa, tc::a_rows<kSC>(qs, warp * 16, kk * 16, lane));
        scale_frag(qa, a.scale);
        uint32_t da[4];
        if (kDp)
          tc::ldmatrix_x4(da, tc::a_rows<kSC>(ks + kRows * kSC, warp * 16,
                                              kk * 16, lane));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t kf[4];
          tc::ldmatrix_x4(kf, tc::b_rows<kSC>(ks, jj * 16, kk * 16, lane));
          tc::mma_bf16(s[2 * jj], qa, kf[0], kf[1]);
          tc::mma_bf16(s[2 * jj + 1], qa, kf[2], kf[3]);
          if (kDp) {
            uint32_t vf[4];
            tc::ldmatrix_x4(vf, tc::b_rows<kSC>(ks + 2 * kRows * kSC,
                                                jj * 16, kk * 16, lane));
            tc::mma_bf16(dp[2 * jj], da, vf[0], vf[1]);
            tc::mma_bf16(dp[2 * jj + 1], da, vf[2], vf[3]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward 1: the masked scores of one 64 x 64 tile and their row maxima
// into the workspace
// ---------------------------------------------------------------------------

// Forward workspace (fp32): the scores of every (b, h) tile (query tile,
// key tile), 4096 each in the accumulator order of the warp that owns them
// (warp w, n-tile j, lane: four floats, (w * 8 + j) * 32 + lane), then the
// row maxima of every tile, [B * H][Tq64][n key tiles], then with dropout
// each tile's mask as philox::tile_drop_bits words, one per lane
// (w * 32 + lane), [B * H][n query tiles][n key tiles][128].
__device__ __forceinline__ long long tile_index(int bh, int qt, int kt,
                                                int nq, int nk) {
  return (static_cast<long long>(bh) * nq + qt) * nk + kt;
}

template <bool kDropout>
__global__ void __launch_bounds__(kTcThreads) wide_scores_tc(Args a) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);
  float* bias_s = reinterpret_cast<float*>(ring + kStages * 2 * kRows * kSC);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int H = a.num_heads, tk = a.tk;
  const int kt = blockIdx.x, qt = blockIdx.y, bh = blockIdx.z;
  const int k0 = kt * kRows, q0 = qt * kRows, b = bh / H, h = bh % H;
  if (a.causal && k0 > q0 + kRows - 1) return;  // above the diagonal

  float s[8][4], unused[8][4];
  tile_products<false>(a, b, h, q0, k0, ring, bias_s, s, unused);

  // bias, then the causal and ragged masks, and the row maxima
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const bool edge = (a.causal && k0 + kRows > q0) || k0 + kRows > tk;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = 8 * j + 2 * t + (e & 1), kj = k0 + kc;
      float x = s[j][e];
      if (a.use_bias) x += bias_s[kc];
      if (edge) {
        if (a.causal && kj > row0 + 8 * (e >> 1)) x = kNegInf;
        if (kj >= tk) x = -INFINITY;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  const int nq = gridDim.y, nk = gridDim.x;
  const long long tile = tile_index(bh, qt, kt, nq, nk);
  float4* st = reinterpret_cast<float4*>(static_cast<float*>(a.ws) +
                                         tile * kTileElems);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st[(warp * 8 + j) * 32 + lane] =
        make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  const long long n_all = static_cast<long long>(gridDim.z) * nq * nk;
  float* tmax = static_cast<float*>(a.ws) + n_all * kTileElems;
  if (kDropout) {  // the tile's mask, drawn once for every output slice
    unsigned* words = reinterpret_cast<unsigned*>(tmax + n_all * kRows);
    words[tile * kTcThreads + tid] = philox::tile_drop_bits(
        static_cast<unsigned long long>(*a.seed), k0, row0,
        h + a.head_offset, b,
        a.threshold, t);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    if (t == 0)
      tmax[(static_cast<long long>(bh) * nq * kRows + row0 + 8 * r) * nk +
           kt] = mx[r];
  }
}

// ---------------------------------------------------------------------------
// forward 2: softmax at the row's final max and P.V, a block owning 64
// query rows and one slice of the output columns
// ---------------------------------------------------------------------------

template <bool kDropout>
__global__ void __launch_bounds__(kTcThreads) wide_pv_tc(Args a) {
  // stage st: the V slice [64][kSV] bf16, then the score tile, 4096 fp32
  extern __shared__ __align__(16) unsigned char smem_tc[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x / a.n_col, slice = blockIdx.x % a.n_col;
  const int b = blockIdx.y;
  // row blocks from the last, so a causal grid starts its longest first
  const int qt = gridDim.z - 1 - blockIdx.z, q0 = qt * kRows;
  const int D = a.head_dim, tq = a.tq, tk = a.tk, H = a.num_heads;
  const int col0 = slice * a.col_w, width = min(a.col_w, D - col0);
  const int n16 = width / 16;  // 16-column steps of the block's slice
  const int nq = gridDim.z, nk = n_tiles_of(tk), bh = b * H + h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * D;
  // causal rows of this block see no key beyond q0 + 63
  const int k_end = a.causal ? min(tk, q0 + kRows) : tk;
  const int n_tiles = n_tiles_of(k_end);
  const long long tile0 = tile_index(bh, qt, 0, nq, nk);
  const long long n_all = static_cast<long long>(gridDim.y) * H * nq * nk;
  const float* sb = static_cast<const float*>(a.ws) + tile0 * kTileElems;
  const float* tmax = static_cast<const float*>(a.ws) + n_all * kTileElems;
  const unsigned* words =
      reinterpret_cast<const unsigned*>(tmax + n_all * kRows);

  // the V slice of key tile i (rows beyond Tk zero), the tile's scores and
  // with dropout its mask words into stage i % 2
  auto load_tile = [&](int i) {
    unsigned char* stage = smem_tc + (i & 1) * kPvStage;
    bf16* vs = reinterpret_cast<bf16*>(stage);
    for (int c = tid; c < kRows * (kSlice / 8); c += kTcThreads) {
      const int r = c >> 5, col = (c & 31) * 8, kj = i * kRows + r;
      if (col < width)
        tc::cp_async16(vs + r * kSV + col,
                       vb + static_cast<long long>(kj < tk ? kj : 0) *
                                a.v_sr + col0 + col, kj < tk);
    }
    float* ss = reinterpret_cast<float*>(stage + kRows * kSV * 2);
    const float* st = sb + i * kTileElems;
    for (int c = tid; c < kTileElems / 4; c += kTcThreads)
      tc::cp_async16(ss + 4 * c, st + 4 * c, true);
    if (kDropout && tid < kTcThreads / 4)
      tc::cp_async16(ss + kTileElems + 4 * tid,
                     words + (tile0 + i) * kTcThreads + 4 * tid, true);
    tc::cp_async_commit();
  };
  load_tile(0);

  // the rows' final max, from the tiles' maxima
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float m[2], l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = tmax + (static_cast<long long>(bh) * nq * kRows +
                               row0 + 8 * r) * nk;
    m[r] = -INFINITY;
    for (int i = 0; i < n_tiles; ++i) m[r] = fmaxf(m[r], row[i]);
  }
  bf16* p_s = reinterpret_cast<bf16*>(smem_tc + 2 * kPvStage);  // [64][kSC]
  float* inv_s = reinterpret_cast<float*>(p_s + kRows * kSC);   // [64]

  SliceAcc acc;
  zero_acc(acc);
  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1 and p are consumed
    if (it + 1 < n_tiles) load_tile(it + 1);
    const unsigned char* stage = smem_tc + (it & 1) * kPvStage;
    // this warp's rows: p = exp(s - m), the reference's p (at the row's
    // final max), l over the unmasked p, round(p) of the kept ones into p_s
    const float4* ss =
        reinterpret_cast<const float4*>(stage + kRows * kSV * 2);
    const unsigned drop =
        kDropout ? reinterpret_cast<const unsigned*>(ss + kTileElems / 4)[tid]
                 : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = ss[(warp * 8 + j) * 32 + lane];
      float p[4] = {expf(x.x - m[0]), expf(x.y - m[0]), expf(x.z - m[1]),
                    expf(x.w - m[1])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        l[e >> 1] += p[e];
        if (kDropout && ((drop >> (4 * j + e)) & 1u)) p[e] = 0.f;
      }
      bf16* pr = p_s + (warp * 16 + g) * kSC + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(pr) = tc::pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(pr + 8 * kSC) = tc::pack_bf16(p[2], p[3]);
    }
    __syncthreads();  // p of all 64 rows is visible
    // acc += round(p) . v over this warp's column groups
    slice_mma<false>(acc, p_s, reinterpret_cast<const bf16*>(stage), n16,
                     warp, lane);
  }

  // o = acc / max(l * keep, 1e-30), rounded, through stage 0's V (no copy
  // in flight) to 16-byte stores; lse = m + log l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    if (t == 0)
      inv_s[warp * 16 + g + 8 * r] =
          1.f / fmaxf(kDropout ? l[r] * a.keep : l[r], 1e-30f);
  }
  __syncthreads();  // 1/l is visible, every warp's products are done
  store_slice(acc, inv_s, reinterpret_cast<bf16*>(smem_tc),
              static_cast<bf16*>(a.out0) + static_cast<long long>(b) * tq *
                                                 (H * D) + h * D + col0,
              H * D, q0, tq, width, warp, lane);
  if (slice == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi < tq)
        a.lse[(static_cast<long long>(b) * tq + qi) * H + h] =
            m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(do . o), one warp per (b, query, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256) wide_delta(Args a, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int H = a.num_heads, D = a.head_dim;
  const int h = row % H, qi = (row / H) % a.tq, b = row / (H * a.tq);
  const bf16* orow = static_cast<const bf16*>(a.o) + b * a.o_sb +
                     qi * a.o_sr + h * D;
  const bf16* dorow = static_cast<const bf16*>(a.dout) + b * a.do_sb +
                      qi * a.do_sr + h * D;
  float part = 0.f;
  for (int c = lane; c < D / 8; c += 32)
    part += tc::dot_bf16x8(*reinterpret_cast<const uint4*>(dorow + 8 * c),
                       *reinterpret_cast<const uint4*>(orow + 8 * c));
  part = warp_sum(part);
  if (lane == 0) a.delta[row] = part;  // [B, Tq, H] row-major is `row`
}

// ---------------------------------------------------------------------------
// backward 2: the rounded g and ds * scale of one 64 x 64 tile into the
// workspace
// ---------------------------------------------------------------------------

// Backward workspace (bf16): round(g), then round(ds * scale), each
// [B * H][Tq64][Tk64] row-major (queries down, keys across).
template <bool kDropout>
__global__ void __launch_bounds__(kTcThreads) wide_ds_tc(Args a) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);
  float* bias_s = reinterpret_cast<float*>(ring + kStages * 4 * kRows * kSC);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int H = a.num_heads, D = a.head_dim, tq = a.tq, tk = a.tk;
  const int k0 = blockIdx.x * kRows, q0 = blockIdx.y * kRows;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  if (a.causal && k0 > q0 + kRows - 1) return;  // above the diagonal

  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const long long at = (static_cast<long long>(b) * tq + qi) * H + h;
    ls[r] = qi < tq ? a.lse[at] : 0.f;
    dl[r] = qi < tq ? a.delta[at] : 0.f;
  }
  unsigned drop = 0;
  if (kDropout)
    drop = philox::tile_drop_bits(static_cast<unsigned long long>(*a.seed),
                                  k0, row0, h + a.head_offset, b,
                                  a.threshold, t);

  float s[8][4], dp[8][4];
  tile_products<true>(a, b, h, q0, k0, ring, bias_s, s, dp);

  // p = exp(s - lse) (0 at keys and queries beyond the call); g = keep ?
  // p : 0 left in s, ds * scale = p * (dw - delta) * scale left in dp
  const bool edge =
      (a.causal && k0 + kRows > q0) || k0 + kRows > tk || q0 + kRows > tq;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = 8 * j + 2 * t + (e & 1), kj = k0 + kc;
      const int qi = row0 + 8 * (e >> 1);
      float x = s[j][e];
      if (a.use_bias) x += bias_s[kc];
      if (edge) {
        if (a.causal && kj > qi) x = kNegInf;
        if (kj >= tk) x = -INFINITY;
      }
      float p = expf(x - ls[e >> 1]);
      if (edge && qi >= tq) p = 0.f;
      float dw = dp[j][e], gv = p;
      if (kDropout) {
        const bool dropped = (drop >> (4 * j + e)) & 1u;
        gv = dropped ? 0.f : p;
        dw = dropped ? 0.f : __fmul_rn(dw, a.keep);
      }
      s[j][e] = gv;
      dp[j][e] = p * (dw - dl[e >> 1]) * a.scale;
    }

  // both tiles, rounded to bf16, through this warp's rows of the ring
  // stage that tile_products left free, to 16-byte stores
  const int nc = (D + kChunk - 1) / kChunk;
  bf16* g_s = ring + (nc % kStages) * 4 * kRows * kSC + warp * 16 * kSC;
  bf16* d_s = g_s + kRows * kSC;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int off0 = g * kSC + 8 * j + 2 * t, off1 = off0 + 8 * kSC;
    *reinterpret_cast<uint32_t*>(g_s + off0) = tc::pack_bf16(s[j][0], s[j][1]);
    *reinterpret_cast<uint32_t*>(g_s + off1) = tc::pack_bf16(s[j][2], s[j][3]);
    *reinterpret_cast<uint32_t*>(d_s + off0) =
        tc::pack_bf16(dp[j][0], dp[j][1]);
    *reinterpret_cast<uint32_t*>(d_s + off1) =
        tc::pack_bf16(dp[j][2], dp[j][3]);
  }
  __syncwarp();
  const long long tq64 = gridDim.y * kRows, tk64 = gridDim.x * kRows;
  bf16* wg = static_cast<bf16*>(a.ws) +
             (static_cast<long long>(bh) * tq64 + q0 + warp * 16) * tk64 + k0;
  bf16* wd = wg + gridDim.z * tq64 * tk64;
  for (int c = lane; c < 16 * 8; c += 32) {
    const int r = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(wg + r * tk64 + col) =
        *reinterpret_cast<const uint4*>(g_s + r * kSC + col);
    *reinterpret_cast<uint4*>(wd + r * tk64 + col) =
        *reinterpret_cast<const uint4*>(d_s + r * kSC + col);
  }
}

// ---------------------------------------------------------------------------
// backward 3: dq, dk and dv from the workspace, one 64-row block of one
// output slice per block
// ---------------------------------------------------------------------------

// kRole 0: dq = dss . k over key tiles; 1: dk = dss^T . q over query tiles;
// 2: dv = round(g)^T . round(do / keep) over query tiles.  rb is the row
// block (queries for dq, keys for dk and dv).
template <int kRole, bool kDropout>
__device__ __forceinline__ void wide_grad_block(const Args& a, int rb,
                                                int slice, int bh,
                                                unsigned char* smem) {
  bf16* ring = reinterpret_cast<bf16*>(smem);  // [2][64 kSC + 64 kSV]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = a.num_heads, D = a.head_dim, tq = a.tq, tk = a.tk;
  const int b = bh / H, h = bh % H;
  const int r0 = rb * kRows;
  const int col0 = slice * a.col_w, width = min(a.col_w, D - col0);
  const int n16 = width / 16;
  const long long tq64 = n_tiles_of(tq) * kRows, tk64 = n_tiles_of(tk) * kRows;
  // this (b, h)'s tiles of round(ds * scale) (dq, dk) or round(g) (dv)
  const bf16* ws = static_cast<const bf16*>(a.ws) +
                   (kRole == 2 ? 0 : gridDim.z * tq64 * tk64) +
                   static_cast<long long>(bh) * tq64 * tk64;
  // the B rows: keys (dq), queries (dk: q, dv: do)
  const bf16* src;
  long long src_sr;
  int src_rows;
  if (kRole == 0) {
    src = static_cast<const bf16*>(a.k) + b * a.k_sb + h * D;
    src_sr = a.k_sr;
    src_rows = tk;
  } else if (kRole == 1) {
    src = static_cast<const bf16*>(a.q) + b * a.q_sb + h * D;
    src_sr = a.q_sr;
    src_rows = tq;
  } else {
    src = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * D;
    src_sr = a.do_sr;
    src_rows = tq;
  }
  // the tiles this block sums over: dq the key tiles up to its last
  // visible key; dk and dv the query tiles from its first key on (causal)
  int first, n_steps;
  if (kRole == 0) {
    first = 0;
    n_steps = n_tiles_of(a.causal ? min(tk, r0 + kRows) : tk);
  } else {
    first = a.causal ? rb : 0;
    n_steps = n_tiles_of(tq) - first;
  }

  // step i: the workspace tile (queries down, keys across) and the tile's
  // 64 B rows of the block's columns into stage i % 2
  auto load_step = [&](int i) {
    bf16* as = ring + (i & 1) * (kRows * kSC + kRows * kSV);
    bf16* bs = as + kRows * kSC;
    const int x = first + i;  // key tile (dq) or query tile (dk, dv)
    const bf16* wt = kRole == 0 ? ws + r0 * tk64 + x * kRows
                                : ws + x * kRows * tk64 + r0;
    for (int c = tid; c < kRows * 8; c += kTcThreads) {
      const int r = c >> 3, col = (c & 7) * 8;
      tc::cp_async16(as + r * kSC + col, wt + r * tk64 + col, true);
    }
    for (int c = tid; c < kRows * (kSlice / 8); c += kTcThreads) {
      const int r = c >> 5, col = (c & 31) * 8, row = x * kRows + r;
      if (col < width)
        tc::cp_async16(bs + r * kSV + col,
                       src + static_cast<long long>(
                                 row < src_rows ? row : 0) * src_sr +
                           col0 + col,
                       row < src_rows);
    }
    tc::cp_async_commit();
  };
  if (n_steps > 0) load_step(0);

  SliceAcc acc;
  zero_acc(acc);
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      load_step(i + 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    bf16* as = ring + (i & 1) * (kRows * kSC + kRows * kSV);
    bf16* bs = as + kRows * kSC;
    if (kRole == 2 && kDropout) {
      // round(do / keep): each thread scales the chunks its own copies
      // brought in, before the barrier publishes them
      for (int c = tid; c < kRows * (kSlice / 8); c += kTcThreads) {
        const int r = c >> 5, col = (c & 31) * 8;
        if (col < width) {
          uint4* x = reinterpret_cast<uint4*>(bs + r * kSV + col);
          *x = tc::scale_bf16x8(*x, a.keep);
        }
      }
    }
    __syncthreads();
    // dss rows as stored (dq); the stored tile transposed, the block's
    // keys down and the tile's queries across (dk, dv)
    slice_mma<kRole != 0>(acc, as, bs, n16, warp, lane);
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // the block's rows through stage 0's B tile (no copy in flight, every
  // warp past the last barrier) to 16-byte stores
  const int rows = kRole == 0 ? tq : tk;
  bf16* out = static_cast<bf16*>(kRole == 0 ? a.out0
                                            : kRole == 1 ? a.dk : a.dv);
  store_slice(acc, nullptr, ring + kRows * kSC,
              out + static_cast<long long>(b) * rows * (H * D) + h * D +
                  col0,
              H * D, r0, rows, width, warp, lane);
}

// grid (3 x n_col, row blocks, B x H): x / n_col picks dq, dk or dv
template <bool kDropout>
__global__ void __launch_bounds__(kTcThreads) wide_grad_tc(Args a) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int role = blockIdx.x / a.n_col, slice = blockIdx.x % a.n_col;
  const int n_q = n_tiles_of(a.tq), n_k = n_tiles_of(a.tk);
  const int y = blockIdx.y;
  // causal: dq's last query blocks and dk/dv's first key blocks are the
  // longest, and start first
  if (role == 0) {
    if (y < n_q)
      wide_grad_block<0, kDropout>(a, n_q - 1 - y, slice, blockIdx.z,
                                   smem_tc);
  } else if (y < n_k) {
    if (role == 1)
      wide_grad_block<1, kDropout>(a, y, slice, blockIdx.z, smem_tc);
    else
      wide_grad_block<2, kDropout>(a, y, slice, blockIdx.z, smem_tc);
  }
}

// ===========================================================================
// fp32: scalar FMA
// ===========================================================================

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlock = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kTile = 32;                      // streamed rows per tile
constexpr int kFChunk = 128;                   // head-dim chunk
constexpr int kLd = kFChunk + 1;               // tile row stride (floats)
constexpr int kColsPerLane = kFChunk / 32;

// rows r0.. of a [T, D] matrix (row stride sr, head offset applied),
// columns c0 .. c0 + n, into tile[kTile][kLd] times mul; rows at or beyond
// n_rows and columns past n are zero
__device__ __forceinline__ void stage(float* tile, const float* base,
                                      long long sr, int r0, int n_rows,
                                      int c0, int n, float mul) {
  for (int i = threadIdx.x; i < kTile * kFChunk; i += kWarps * 32) {
    const int r = i / kFChunk, c = i - r * kFChunk, row = r0 + r;
    tile[r * kLd + c] =
        row < n_rows && c < n ? base[row * sr + c0 + c] * mul : 0.f;
  }
}

// forward: a block owns 32 query rows and 128 output columns of one head
template <bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_wide_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [32][kLd] q chunk, scaled
  float* k_s = q_s + kTile * kLd;    // [32][kLd] k chunk
  float* v_s = k_s + kTile * kLd;    // [32][kLd] v, the block's columns
  float* p_s = v_s + kTile * kLd;    // [8][4][32] p
  float* bias_s = p_s + kWarps * kRowsPerWarp * kTile;  // [32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlock, b = blockIdx.z;
  const int h = blockIdx.y / a.n_col, col0 = (blockIdx.y % a.n_col) * kFChunk;
  const int D = a.head_dim, H = a.num_heads, tq = a.tq, tk = a.tk;
  const int n_out = min(kFChunk, D - col0);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * D;
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
    for (int c0 = 0; c0 < D; c0 += kFChunk) {
      const int n = min(kFChunk, D - c0);
      __syncthreads();  // the previous chunk is consumed
      stage(q_s, qb, a.q_sr, q0, tq, c0, n, a.scale);
      stage(k_s, kb, a.k_sr, k0, tk, c0, n, 1.f);
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
    stage(v_s, vb, a.v_sr, k0, tk, col0, n_out, 1.f);
    if (tid < kTile) {
      const int kj = k0 + tid;
      bias_s[tid] = (a.use_bias && kj < tk) ? a.bias[(long long)b * tk + kj]
                                            : 0.f;
    }
    __syncthreads();

    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout)
      bits = philox::dropout_bits(sd, (k0 >> 2) + (lane & 7),
                                  q0 + warp * kRowsPerWarp + (lane >> 3),
                                  h + a.head_offset, b);
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
      p_s[(warp * kRowsPerWarp + i) * kTile + lane] = p;
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

  float* ob = static_cast<float*>(a.out0);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    const float r = 1.f / fmaxf(kDropout ? l[i] * a.keep : l[i], 1e-30f);
    float* orow = ob + ((long long)b * tq + qi) * (H * D) + h * D + col0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (lane + 32 * j < n_out) orow[lane + 32 * j] = acc[i][j] * r;
    if (lane == 0 && col0 == 0)
      a.lse[((long long)b * tq + qi) * H + h] = m[i] + logf(l[i]);
  }
}

// backward, dq (and delta): a block owns 32 query rows, 128 dq columns
template <bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_wide_dq_kernel(Args a) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // q chunk, scaled
  float* do_s = q_s + kTile * kLd;   // do chunk
  float* k_s = do_s + kTile * kLd;   // k chunk, then k of the block's cols
  float* v_s = k_s + kTile * kLd;    // v chunk
  float* ds_s = v_s + kTile * kLd;   // [8][4][32] ds * scale
  float* bias_s = ds_s + kWarps * kRowsPerWarp * kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlock, b = blockIdx.z;
  const int h = blockIdx.y / a.n_col, col0 = (blockIdx.y % a.n_col) * kFChunk;
  const int D = a.head_dim, H = a.num_heads, tq = a.tq, tk = a.tk;
  const int n_out = min(kFChunk, D - col0);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * D;
  const float* ob = static_cast<const float*>(a.o) + b * a.o_sb + h * D;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * D;
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
        part += dob[qi * a.do_sr + d] * ob[qi * a.o_sr + d];
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
    for (int c0 = 0; c0 < D; c0 += kFChunk) {
      const int n = min(kFChunk, D - c0);
      __syncthreads();
      stage(q_s, qb, a.q_sr, q0, tq, c0, n, a.scale);
      stage(do_s, dob, a.do_sr, q0, tq, c0, n, 1.f);
      stage(k_s, kb, a.k_sr, k0, tk, c0, n, 1.f);
      stage(v_s, vb, a.v_sr, k0, tk, c0, n, 1.f);
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
    stage(k_s, kb, a.k_sr, k0, tk, col0, n_out, 1.f);
    if (tid < kTile) {
      const int kj = k0 + tid;
      bias_s[tid] = (a.use_bias && kj < tk) ? a.bias[(long long)b * tk + kj]
                                            : 0.f;
    }
    __syncthreads();

    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout)
      bits = philox::dropout_bits(sd, (k0 >> 2) + (lane & 7),
                                  q0 + warp * kRowsPerWarp + (lane >> 3),
                                  h + a.head_offset, b);
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
          p * (dw - delta[i]) * a.scale;
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

  float* dqb = static_cast<float*>(a.out0);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    float* row = dqb + ((long long)b * tq + qi) * (H * D) + h * D + col0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (lane + 32 * j < n_out) row[lane + 32 * j] = acc[i][j];
  }
}

// backward, dk and dv: a block owns 32 keys and 128 columns of each
template <bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) mha_wide_dkdv_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs_s = smem;                 // q chunk scaled; then raw q
  float* do_s = qs_s + kTile * kLd;   // do chunk; then do / keep
  float* k_s = do_s + kTile * kLd;    // k chunk of the block's keys
  float* v_s = k_s + kTile * kLd;     // v chunk of the block's keys
  float* g_s = v_s + kTile * kLd;     // [8][4][32] g
  float* ds_s = g_s + kWarps * kRowsPerWarp * kTile;  // ds * scale
  float* lse_s = ds_s + kWarps * kRowsPerWarp * kTile;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kBlock, b = blockIdx.z;
  const int h = blockIdx.y / a.n_col, col0 = (blockIdx.y % a.n_col) * kFChunk;
  const int D = a.head_dim, H = a.num_heads, tq = a.tq, tk = a.tk;
  const int n_out = min(kFChunk, D - col0);
  const float* qb = static_cast<const float*>(a.q) + b * a.q_sb + h * D;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_sb + h * D;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_sb + h * D;
  const float* dob = static_cast<const float*>(a.dout) + b * a.do_sb + h * D;
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
    for (int c0 = 0; c0 < D; c0 += kFChunk) {
      const int n = min(kFChunk, D - c0);
      __syncthreads();
      stage(qs_s, qb, a.q_sr, q0, tq, c0, n, a.scale);
      stage(do_s, dob, a.do_sr, q0, tq, c0, n, 1.f);
      stage(k_s, kb, a.k_sr, k0, tk, c0, n, 1.f);
      stage(v_s, vb, a.v_sr, k0, tk, c0, n, 1.f);
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
    stage(qs_s, qb, a.q_sr, q0, tq, col0, n_out, 1.f);
    stage(do_s, dob, a.do_sr, q0, tq, col0, n_out, a.keep);
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
      g_s[(warp * kRowsPerWarp + i) * kTile + lane] = g;
      ds_s[(warp * kRowsPerWarp + i) * kTile + lane] =
          p * (dw - delta_s[lane]) * a.scale;
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

  float* dkb = static_cast<float*>(a.dk);
  float* dvb = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int kj = key0 + i;
    if (kj >= tk) continue;
    const long long off = ((long long)b * tk + kj) * (H * D) + h * D + col0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      if (lane + 32 * j < n_out) {
        dkb[off + lane + 32 * j] = dk[i][j];
        dvb[off + lane + 32 * j] = dv[i][j];
      }
  }
}

constexpr int kFwdSmem =
    (3 * kTile * kLd + kWarps * kRowsPerWarp * kTile + kTile) * 4;
constexpr int kDqSmem =
    (4 * kTile * kLd + kWarps * kRowsPerWarp * kTile + kTile) * 4;
constexpr int kDkdvSmem =
    (4 * kTile * kLd + 2 * kWarps * kRowsPerWarp * kTile + 2 * kTile) * 4;
static_assert(kScoresSmem <= 232448 && kPvSmem <= 232448 &&
                  kDsSmem <= 232448 && kGradSmem <= 232448,
              "a block takes at most 227 KB of shared memory");

// ===========================================================================
// launches
// ===========================================================================

// dynamic shared memory above 48 KB needs the opt-in, once per kernel
template <typename K>
cudaError_t opt_in(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <bool kDropout>
cudaError_t launch_fwd_tc(const Args& a, int batch, cudaStream_t s) {
  static bool done_s = false, done_pv = false;
  cudaError_t e = opt_in(wide_scores_tc<kDropout>, kScoresSmem, &done_s);
  if (e != cudaSuccess) return e;
  e = opt_in(wide_pv_tc<kDropout>, kPvSmem, &done_pv);
  if (e != cudaSuccess) return e;
  const int n_q = n_tiles_of(a.tq), n_k = n_tiles_of(a.tk);
  wide_scores_tc<kDropout><<<dim3(n_k, n_q, batch * a.num_heads),
                             kTcThreads, kScoresSmem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wide_pv_tc<kDropout><<<dim3(a.num_heads * a.n_col, batch, n_q),
                         kTcThreads, kPvSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_bwd_tc(const Args& a, int batch, cudaStream_t s) {
  static bool done_ds = false, done_grad = false;
  cudaError_t e = opt_in(wide_ds_tc<kDropout>, kDsSmem, &done_ds);
  if (e != cudaSuccess) return e;
  e = opt_in(wide_grad_tc<kDropout>, kGradSmem, &done_grad);
  if (e != cudaSuccess) return e;
  const int rows = batch * a.tq * a.num_heads;
  wide_delta<<<(rows + 7) / 8, 256, 0, s>>>(a, rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n_q = n_tiles_of(a.tq), n_k = n_tiles_of(a.tk);
  wide_ds_tc<kDropout><<<dim3(n_k, n_q, batch * a.num_heads), kTcThreads,
                         kDsSmem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wide_grad_tc<kDropout><<<dim3(3 * a.n_col, n_q > n_k ? n_q : n_k,
                                batch * a.num_heads),
                           kTcThreads, kGradSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_fwd_fp32(const Args& a, int batch, cudaStream_t s) {
  static bool done = false;
  cudaError_t e = opt_in(mha_wide_fwd_kernel<kDropout>, kFwdSmem, &done);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.tq + kBlock - 1) / kBlock, a.num_heads * a.n_col,
                  batch);
  mha_wide_fwd_kernel<kDropout><<<grid, kWarps * 32, kFwdSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_bwd_fp32(const Args& a, int batch, cudaStream_t s) {
  static bool done_q = false, done_k = false;
  cudaError_t e = opt_in(mha_wide_dq_kernel<kDropout>, kDqSmem, &done_q);
  if (e != cudaSuccess) return e;
  e = opt_in(mha_wide_dkdv_kernel<kDropout>, kDkdvSmem, &done_k);
  if (e != cudaSuccess) return e;
  const dim3 grid_q((a.tq + kBlock - 1) / kBlock, a.num_heads * a.n_col,
                    batch);
  mha_wide_dq_kernel<kDropout><<<grid_q, kWarps * 32, kDqSmem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 grid_k((a.tk + kBlock - 1) / kBlock, a.num_heads * a.n_col,
                    batch);
  mha_wide_dkdv_kernel<kDropout><<<grid_k, kWarps * 32, kDkdvSmem, s>>>(a);
  return cudaGetLastError();
}

bool bad_head_dim(int dtype, int head_dim) {
  return (dtype != 0 && dtype != 1) || head_dim < 32 ||
         head_dim > kMaxHeadDim || head_dim % 32;
}

// the output slices of a head: bf16 ceil(D / 256) of equal width rounded
// up to 16 columns (the last one narrower), fp32 128 columns each
void set_slices(Args* a, int dtype) {
  const int d = a->head_dim;
  if (dtype == 1) {
    a->n_col = (d + kSlice - 1) / kSlice;
    a->col_w = ((d + a->n_col - 1) / a->n_col + 15) / 16 * 16;
  } else {
    a->n_col = (d + kFChunk - 1) / kFChunk;
    a->col_w = kFChunk;
  }
}

}  // namespace

// As mha_fwd (mha_fwd.cu), for head dims that are a multiple of 32 up to
// 1024 (any such D; refused otherwise).  workspace (bf16 only; ignored for
// fp32): fp32, B * H * Tq64 * (Tk64 + 3 * Tk64 / 64) elements, Tq and Tk
// rounded up to multiples of 64 (ops/mha.py wide_workspace).
extern "C" int mha_wide_fwd(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* bias,
                            const void* seed, void* o, void* lse,
                            void* workspace, int batch, int tq, int tk,
                            int num_heads, int head_offset, long long q_sb,
                            long long q_sr,
                            long long k_sb, long long k_sr, long long v_sb,
                            long long v_sr, float scale, int causal,
                            int use_bias, int dropout, unsigned threshold,
                            float keep_prob, void* stream) {
  if (bad_head_dim(dtype, head_dim) || (dtype == 1 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.seed = static_cast<const long long*>(seed);
  a.out0 = o;
  a.lse = static_cast<float*>(lse);
  a.ws = workspace;
  a.tq = tq;
  a.tk = tk;
  a.num_heads = num_heads;
  a.head_offset = head_offset;
  a.head_dim = head_dim;
  set_slices(&a, dtype);
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
    return static_cast<int>(dropout ? launch_fwd_tc<true>(a, batch, s)
                                    : launch_fwd_tc<false>(a, batch, s));
  return static_cast<int>(dropout ? launch_fwd_fp32<true>(a, batch, s)
                                  : launch_fwd_fp32<false>(a, batch, s));
}

// As mha_bwd (mha_bwd.cu), for head dims that are a multiple of 32 up to
// 1024.  workspace (bf16 only; ignored for fp32): bf16 [2, B, H, Tq64,
// Tk64], Tq and Tk rounded up to multiples of 64, contiguous (ops/mha.py
// wide_workspace); every element the products read is written first.
extern "C" int mha_wide_bwd(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* bias,
                            const void* seed, const void* o, const void* lse,
                            const void* dout, void* dq, void* dk, void* dv,
                            void* delta, void* workspace, int batch, int tq,
                            int tk, int num_heads, int head_offset,
                            long long q_sb,
                            long long q_sr, long long k_sb, long long k_sr,
                            long long v_sb, long long v_sr, long long o_sb,
                            long long o_sr, long long do_sb, long long do_sr,
                            float scale, int causal, int use_bias,
                            int dropout, unsigned threshold, float inv_keep,
                            void* stream) {
  if (bad_head_dim(dtype, head_dim) || (dtype == 1 && workspace == nullptr))
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
  a.ws = workspace;
  a.tq = tq;
  a.tk = tk;
  a.num_heads = num_heads;
  a.head_offset = head_offset;
  a.head_dim = head_dim;
  set_slices(&a, dtype);
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
    return static_cast<int>(dropout ? launch_bwd_tc<true>(a, batch, s)
                                    : launch_bwd_tc<false>(a, batch, s));
  return static_cast<int>(dropout ? launch_bwd_fp32<true>(a, batch, s)
                                  : launch_bwd_fp32<false>(a, batch, s));
}

extern "C" const char* mha_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
