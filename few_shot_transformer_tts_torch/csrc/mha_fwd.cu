// Multi-head attention forward for Hopper (sm_90a), packed [B, T, H*D] layout.
//
// Replaces the forward of the TPU kernel `mha_train`
// (few_shot_transformer_tts_tpu/ops/pallas_attention_train.py, `_fwd` and
// its body `_fwd_kernel`).  Per (batch, head, query row):
//
//   s   = (q * scale, rounded to the input type) . k^T      fp32
//   s  += bias[b, key]                 (use_bias: key padding, -1e20)
//   s   = -1e20 where key > query      (causal)
//   m   = max_k s,  l = sum_k exp(s - m),  lse = m + log l  (fp32, [B,Tq,H])
//   g   = p where the dropout mask keeps the key, else 0    (rate > 0)
//   o   = (sum_k round(g_k) v_k) * 1/max(l * keep, 1e-30)   (input type)
//
// Dropout follows the TPU kernel: the mask applies to the unnormalized p,
// l sums the unmasked p, and 1/keep is folded into the output scale.  The
// mask bits come from philox.cuh, a pure function of (seed, b, h, q, k), so
// the backward (mha_bwd.cu) regenerates them.  Rate 0 is its own template
// instantiation with no mask code.  Keys at or beyond Tk are excluded (the
// TPU kernel pads them at -1e30, whose exponent is exactly 0 in fp32).
//
// Bound.  The function must read q, k, v and bias once and write o and lse
// once: at the flagship decoder's causal training shape (B=16, T=448,
// C=768, bf16) that is 44 MB, 13 us at 3.35 TB/s, against 2.5 GFLOP of
// products, 2.5 us at the 989 TFLOP/s bf16 tensor-core rate -- bytes bound
// it, as at every flagship shape.
//
// Design (bf16, mha_fwd_tc).  The TPU kernel keeps a whole K/V in VMEM; a
// Hopper block owns 64 query rows of one (batch, head) -- grid
// (H, B, ceil(Tq/64)), 4 warps of 16 rows -- so each K/V byte staged in
// shared memory serves 64 rows, and K/V stream through a two-stage ring of
// 64-key tiles filled by 16-byte cp.async, the next tile's copy in flight
// while this tile's math runs.  Both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate, tensor_core.cuh): q, scaled
// and rounded where the TPU kernel rounds it, is staged once and held as A
// fragments; S = q.k^T stays in registers, the online softmax runs on the
// accumulator fragments in fp32, and p, rounded to bf16 where the TPU
// kernel casts it, becomes the A operand of P.V without leaving registers.
// Causal blocks stop at their last visible key tile and mask only the
// diagonal one.  With dropout, a lane draws one Philox block (4 keys of one
// row) per 8-key column tile and trades half of it with its neighbour lane,
// which holds the other row of those keys: 8 generator calls per lane per
// tile, one per 4 scores, the bits of philox.cuh's (k/4, q, h, b) mapping
// (philox::tile_drop_bits), drawn while the tile's copy is in flight.
// q, k and v are read through their row strides (split views of a fused
// QKV projection pass as they are); their base addresses and strides must
// be 16-byte multiples (ops/mha.py checks).  o leaves through shared memory
// in 16-byte rows.
//
// fp32 (mha_fwd_fp32): the tensor cores would need TF32, which would change
// the reference's numerics, so fp32 keeps the scalar kernel: 32 query rows
// per block, 32-key tiles, lane j owning key j, FMA from shared memory.
//
// Head dims.  One library per head dim D (nvcc -DHEAD_DIM=<D>, D a multiple
// of 32 from 32 to 256; ops/cuda_build.py), so each build compiles one
// instantiation.  Registers grow with D: at D <= 128 a warp holds its q
// fragments (D/4 registers) beside the D/2 output accumulators and the 32
// of the score tile, as at the flagship's D = 64 and 96; above 128 that
// would pass 220 registers at D = 256, so q stays in shared memory and
// each key tile reloads its fragments with ldmatrix (q_s is read by its own
// warp only).  Shared memory, (64 + 4 * 64) rows of D + 8 bf16, is 169 KB
// at D = 256.  The fp32 kernel's tiles pass 48 KB above D = 96, so there
// its shared memory is dynamic.
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches on the given stream, allocates nothing, and returns
// cudaGetLastError() after the launch.

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

constexpr float kNegInf = -1e20f;  // causal mask value
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcRows = 64;      // query rows per block, 16 per warp
constexpr int kTcKeys = 64;      // keys per tile

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const long long* seed;
  void* o;
  float* lse;
  int tq, tk, num_heads, head_offset;
  long long q_sb, q_sr, k_sb, k_sr, v_sb, v_sr;
  float scale;
  int causal, use_bias;
  unsigned threshold;
  float keep_prob;
};

template <int D>
constexpr int fwd_tc_smem_bytes() {
  // q (then o) [64][D+8]; k and v in two stages [2][2][64][D+8]; bias [2][64]
  return (kTcRows + 4 * kTcKeys) * (D + 8) * 2 + 2 * kTcKeys * 4;
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kTcThreads) mha_fwd_tc(FwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int S = D + 8;         // shared row stride, elements
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int kSteps = D / 16;   // k-steps of q.k^T
  constexpr int kTiles = D / 8;    // n-tiles of P.V
  constexpr bool kQRegs = D <= 128;  // q fragments held in registers
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_tc);
  bf16* kv_s = q_s + kTcRows * S;  // stage st: k at st*2*64*S, v after it
  float* bias_s = reinterpret_cast<float*>(kv_s + 4 * kTcKeys * S);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // grid (H, B, row blocks): blocks start in the order of blockIdx.z,
  // which walks the row blocks from the last, so a causal grid starts its
  // longest blocks first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;
  const int tq = a.tq, tk = a.tk, H = a.num_heads;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb + h * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * D;
  const float* biasb = a.bias + static_cast<long long>(b) * tk;
  // causal rows of this block see no key beyond q0 + 63
  const int k_end = a.causal ? min(tk, q0 + kTcRows) : tk;
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;

  // one K/V tile (and its bias) into stage st; rows beyond Tk are zero
  auto load_tile = [&](int k0, int st) {
    bf16* ks = kv_s + st * 2 * kTcKeys * S;
    bf16* vs = ks + kTcKeys * S;
    for (int c = tid; c < kTcKeys * kChunks; c += kTcThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8, kj = k0 + r;
      const bool in = kj < tk;
      const long long row = in ? kj : 0;
      tc::cp_async16(ks + r * S + col, kb + row * a.k_sr + col, in);
      tc::cp_async16(vs + r * S + col, vb + row * a.v_sr + col, in);
    }
    if (a.use_bias && tid < kTcKeys) {
      const int kj = k0 + tid;
      tc::cp_async4(bias_s + st * kTcKeys + tid, biasb + (kj < tk ? kj : 0),
                    kj < tk);
    }
    tc::cp_async_commit();
  };
  load_tile(0, 0);

  // q, scaled in fp32 and rounded back to bf16 (the TPU kernel's rounding
  // before its dot); rows beyond Tq are zero and never stored
  for (int c = tid; c < kTcRows * kChunks; c += kTcThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8, qi = q0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (qi < tq)
      x = tc::scale_bf16x8(
          *reinterpret_cast<const uint4*>(qb + qi * a.q_sr + col), a.scale);
    *reinterpret_cast<uint4*>(q_s + r * S + col) = x;
  }
  __syncthreads();
  uint32_t qf[kQRegs ? kSteps : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      tc::ldmatrix_x4(qf[kk], tc::a_rows<S>(q_s, warp * 16, kk * 16, lane));
  }

  float acc[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*a.seed);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTcKeys, st = it & 1;
    if (it + 1 < n_tiles) load_tile(k0 + kTcKeys, st ^ 1);
    unsigned drop = 0;  // the tile's mask, drawn while the copies fly
    if (kDropout)
      drop = philox::tile_drop_bits(sd, k0, row0, h + a.head_offset, b,
                                    a.threshold, t);
    if (it + 1 < n_tiles) {
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv_s + st * 2 * kTcKeys * S;
    const bf16* vs = ks + kTcKeys * S;

    // S = q . k^T: 8 n-tiles of 8 keys, in registers
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        tc::ldmatrix_x4(qa, tc::a_rows<S>(q_s, warp * 16, kk * 16, lane));
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, tc::b_rows<S>(ks, jj * 16, kk * 16, lane));
        tc::mma_bf16(s[2 * jj], qa, kf[0], kf[1]);
        tc::mma_bf16(s[2 * jj + 1], qa, kf[2], kf[3]);
      }
    }

    // bias, then the causal and ragged masks (only the diagonal tile and
    // the last one need them)
    const bool edge =
        (a.causal && k0 + kTcKeys > q0) || k0 + kTcKeys > tk;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * t + (e & 1);
        float x = s[j][e];
        if (a.use_bias) x += bias_s[st * kTcKeys + kc];
        if (edge) {
          const int kj = k0 + kc;
          if (a.causal && kj > row0 + 8 * (e >> 1)) x = kNegInf;
          if (kj >= tk) x = -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax in fp32; a row's four lanes share its max
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;  // l sums the unmasked p
      }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];

    if (kDropout) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((drop >> (4 * j + e)) & 1u) s[j][e] = 0.f;
    }

    // acc = acc * alpha + round(p) . v
#pragma unroll
    for (int n = 0; n < kTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      tc::acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t vf[4];
        tc::ldmatrix_x4_trans(vf, tc::bt_rows<S>(vs, kk * 16, dd * 16, lane));
        tc::mma_bf16(acc[2 * dd], pa, vf[0], vf[1]);
        tc::mma_bf16(acc[2 * dd + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // o = acc / max(l * keep, 1e-30), through this warp's q rows of shared
  // memory (read by this warp only) to 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  const float inv0 = 1.f / fmaxf(kDropout ? l[0] * a.keep_prob : l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(kDropout ? l[1] * a.keep_prob : l[1], 1e-30f);
  bf16* o_s = q_s + warp * 16 * S;
  bf16* ob = static_cast<bf16*>(a.o);
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    *reinterpret_cast<uint32_t*>(o_s + g * S + 8 * n + 2 * t) =
        tc::pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * S + 8 * n + 2 * t) =
        tc::pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < tq)
      *reinterpret_cast<uint4*>(ob + (static_cast<long long>(b) * tq + qi) *
                                         (H * D) + h * D + col) =
          *reinterpret_cast<const uint4*>(o_s + r * S + col);
  }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row0 + 8 * r;
      if (qi < tq)
        a.lse[(static_cast<long long>(b) * tq + qi) * H + h] =
            m[r] + logf(l[r]);
    }
  }
}

template <int D, bool kDropout>
cudaError_t launch_tc(const FwdArgs& a, int batch, cudaStream_t stream) {
  // dynamic shared memory above 48 KB needs the opt-in, once per kernel
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_tc<D, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_tc_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(a.num_heads, batch, (a.tq + kTcRows - 1) / kTcRows);
  mha_fwd_tc<D, kDropout>
      <<<grid, kTcThreads, fwd_tc_smem_bytes<D>(), stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: scalar FMA
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                      // keys per shared-memory tile

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
mha_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             const long long* __restrict__ seed, float* __restrict__ o,
             float* __restrict__ lse, int tq, int tk, int num_heads,
             int head_offset,
             long long q_sb, long long q_sr, long long k_sb, long long k_sr,
             long long v_sb, long long v_sr, float scale, int causal,
             int use_bias, unsigned threshold, float keep_prob) {
  static_assert(D % 32 == 0, "head dim must be a multiple of 32");
  constexpr int kDimsPerLane = D / 32;

  // q [32][D], k [32][D+1] (+1: lane j reads row j, no conflicts), v
  // [32][D], p [8][4][32], bias [32], in dynamic shared memory
  // (fwd_fp32_smem_bytes; above D = 96 it passes 48 KB)
  extern __shared__ float smem_fp32[];
  float(*q_s)[D] = reinterpret_cast<float(*)[D]>(smem_fp32);
  float(*k_s)[D + 1] = reinterpret_cast<float(*)[D + 1]>(q_s + kBlockQ);
  float(*v_s)[D] = reinterpret_cast<float(*)[D]>(k_s + kBlockK);
  float(*p_s)[kRowsPerWarp][kBlockK] =
      reinterpret_cast<float(*)[kRowsPerWarp][kBlockK]>(v_s + kBlockK);
  float* bias_s = reinterpret_cast<float*>(p_s + kWarps);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * q_sb + h * D;
  const float* kb = k + b * k_sb + h * D;
  const float* vb = v + b * v_sb + h * D;
  unsigned long long sd = 0;
  if (kDropout) sd = static_cast<unsigned long long>(*seed);

  // q tile, scaled; rows beyond Tq are zero and never stored.
  for (int idx = tid; idx < kBlockQ * D; idx += blockDim.x) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int qi = q0 + r;
    q_s[r][c] = qi < tq ? qb[qi * q_sr + c] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDimsPerLane; ++d) acc[i][d] = 0.f;
  }

  // causal rows of this block see no key beyond q0 + kBlockQ - 1
  const int k_end = causal ? min(tk, q0 + kBlockQ) : tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * D; idx += blockDim.x) {
      const int r = idx / D, c = idx - (idx / D) * D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < tk) {
        kv = kb[kj * k_sr + c];
        vv = vb[kj * v_sr + c];
      }
      k_s[r][c] = kv;
      v_s[r][c] = vv;
    }
    if (tid < kBlockK) {
      const int kj = k0 + tid;
      bias_s[tid] = (use_bias && kj < tk) ? bias[(long long)b * tk + kj] : 0.f;
    }
    __syncthreads();

    // lane l draws keys k0 + 4*(l&7) .. +3 of row l>>3 of this warp
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (kDropout)
      bits = philox::dropout_bits(sd, (k0 >> 2) + (lane & 7),
                                  q0 + warp * kRowsPerWarp + (lane >> 3),
                                  h + head_offset, b);

    const int kj = k0 + lane;
    const bool valid = kj < tk;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kc = k_s[lane][c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        s[i] = fmaf(q_s[warp * kRowsPerWarp + i][c], kc, s[i]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp * kRowsPerWarp + i;
      float si = s[i];
      if (use_bias) si += bias_s[lane];
      if (causal && kj > qi) si = kNegInf;
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
        if (philox::word(w, lane & 3) < threshold) p = 0.f;
      }
      p_s[warp][i][lane] = p;
#pragma unroll
      for (int d = 0; d < kDimsPerLane; ++d) acc[i][d] *= alpha;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int d = 0; d < kDimsPerLane; ++d) {
        const float vj = v_s[j][lane + 32 * d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          acc[i][d] = fmaf(p_s[warp][i][j], vj, acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= tq) continue;
    const float r = 1.f / fmaxf(kDropout ? l[i] * keep_prob : l[i], 1e-30f);
    float* orow = o + ((long long)b * tq + qi) * (num_heads * D) + h * D;
#pragma unroll
    for (int d = 0; d < kDimsPerLane; ++d) orow[lane + 32 * d] = acc[i][d] * r;
    if (lane == 0)
      lse[((long long)b * tq + qi) * num_heads + h] = m[i] + logf(l[i]);
  }
}

template <int D>
constexpr int fwd_fp32_smem_bytes() {
  return (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D +
          kWarps * kRowsPerWarp * kBlockK + kBlockK) * 4;
}

template <int D, bool kDropout>
cudaError_t launch_fp32(const FwdArgs& a, int batch, cudaStream_t stream) {
  // dynamic shared memory above 48 KB needs the opt-in, set once per kernel
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mha_fwd_fp32<D, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_fp32_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.tq + kBlockQ - 1) / kBlockQ, a.num_heads, batch);
  mha_fwd_fp32<D, kDropout>
      <<<grid, kWarps * 32, fwd_fp32_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.bias, a.seed,
      static_cast<float*>(a.o), a.lse, a.tq, a.tk, a.num_heads,
      a.head_offset, a.q_sb,
      a.q_sr, a.k_sb, a.k_sr, a.v_sb, a.v_sr, a.scale, a.causal, a.use_bias,
      a.threshold, a.keep_prob);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int dtype, bool dropout, const FwdArgs& a, int batch,
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
// elements; the last dim of q, k, v must be contiguous, and for bfloat16
// the base addresses and the batch and row strides must be multiples of 16
// bytes.  bias is [B, Tk] float32 (ignored unless use_bias).  seed points at
// one int64 on the device (read only when dropout != 0); a key is kept when
// its Philox word is >= threshold, and keep_prob = 1 - rate scales the
// output.  head_offset is added to the head of the Philox counter: a
// tensor-parallel rank that holds heads [head_offset, head_offset + H) of a
// layer draws that layer's mask of those heads.  o is [B, Tq, H*D] in the
// input type, lse [B, Tq, H] float32, both contiguous.
extern "C" int mha_fwd(int dtype, int head_dim, const void* q, const void* k,
                       const void* v, const void* bias, const void* seed,
                       void* o, void* lse, int batch, int tq, int tk,
                       int num_heads, int head_offset, long long q_sb,
                       long long q_sr,
                       long long k_sb, long long k_sr, long long v_sb,
                       long long v_sr, float scale, int causal, int use_bias,
                       int dropout, unsigned threshold, float keep_prob,
                       void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{q, k, v, static_cast<const float*>(bias),
                  static_cast<const long long*>(seed), o,
                  static_cast<float*>(lse), tq, tk, num_heads,
                  head_offset, q_sb, q_sr,
                  k_sb, k_sr, v_sb, v_sr, scale, causal, use_bias, threshold,
                  keep_prob};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<HEAD_DIM>(dtype, dropout != 0, a, batch, s);
}

extern "C" const char* mha_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
