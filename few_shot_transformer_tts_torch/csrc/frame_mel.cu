// Fused STFT -> mel for Hopper (sm_90a): pre-emphasised signal to the
// normalised mel in one pass, on a real FFT computed inside the kernel.
//
// Replaces the TPU kernel `fused_frame_mel`
// (few_shot_transformer_tts_tpu/ops/mel_pallas.py, body `_mel_kernel`).  Per
// frame t of a row (n_fft = 2048 samples from t * hop of the reflect-padded
// signal, times the window):
//
//   X_f        = sum_k x_k exp(-2 pi i k f / n_fft)                (fp32)
//   mag_f      = bf16(sqrt(re(X_f)^2 + im(X_f)^2))                 (bf16 value)
//   mel_m      = sum_f mag_f * W_fm          (W bf16 values, fp32 sums)
//   out_m      = clip((20 log10(max(1e-5, mel_m)) - ref + max) / max,
//                     1e-8, 1) * 2 max_abs - max_abs           (symmetric)
//
// Design.  One warp computes one frame; the four warps of a block take
// four neighbouring frames at a time and walk the frames of every row with
// a grid stride, so a 0.4 s input (33 frames) spreads over 9 SMs and a
// batch of 16 x 10 s over all of them.  Rows come in one of two layouts:
// of one width with one frame count (`frame_mel`), or ragged
// (`frame_mel_ragged`: each row its own start in the signal and its own
// frame count, the output rows packed; a warp finds its frame's row by a
// binary search over the frame offsets), so a batch of utterances of
// different lengths computes no frame past any row's end.  Per frame, in
// fp32, in registers and the warp's shared memory (the [BT, n_fft] frames
// and the [BT, 1025] magnitudes never reach device memory):
//   * the frame: the window's nonzero taps at their true offsets (first,
//     first + taps) of the 2048, the rest zero, so the phases are those of
//     the full n_fft DFT; packed as 1024 complex values z_n = x_2n +
//     i x_2n+1 (a real FFT of 2048 points is a complex one of 1024);
//   * a four-step FFT of the 1024 = 32 x 32 points: lane j takes z_{32 n1 +
//     j}, n1 = 0..31, and runs a 32-point radix-2 FFT over n1 in registers;
//     the products go through the twiddles W_1024^(j k1) into shared memory
//     (rows of 33, conflict-free) and back transposed, so lane k1 runs the
//     second 32-point FFT over j: Z_{k1 + 32 k2};
//   * the real-FFT split step: X_f = (Z_f + conj Z_{M-f}) / 2 + W_2048^f
//     (Z_f - conj Z_{M-f}) / 2i for f = 0..1023, X_1024 = re Z_0 - im Z_0;
//     magnitudes rounded to bf16 as the plain version rounds them (re^2,
//     im^2, their sum and the root each rounded once);
//   * the mel product over the filterbank's nonzero weights only (a start
//     bin, a length and bf16 weights per band: 2004 weights at the default
//     config, not 1025 x 80), one band per lane, summed in bin order; the
//     products of two bf16 values are exact in fp32, so only the summation
//     order differs from the plain version's dense product;
//   * the dB / normalise epilogue on the band sums.
// Twiddles come from a host table built in float64 and rounded to fp32 once
// (ops/mel.py fft_twiddles).  No TF32 and no bf16 in the transform: quiet
// bins come from cancellation.  The FFT sums in another order than the
// plain version's DFT product; only a magnitude near a bf16 rounding
// boundary may then round to its neighbour.
//
// Bound.  The signal read once and the mel written once (14 MB for 16 rows
// of 10 s, 4 us) against the operations: a real FFT (~2.5 n log2 n per
// frame), the magnitudes and the sparse mel product, 0.83 GFLOP, 12 us at
// 67 TFLOP/s fp32 -- operations bound it.
//
// Interface: two plain C entries, one per layout, built by nvcc into a
// shared library and loaded with ctypes
// (few_shot_transformer_tts_torch/ops/cuda_build.py).  Each launches on the
// given stream, allocates nothing and returns the launch error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNfft = 2048;
constexpr int kM = kNfft / 2;    // complex points
constexpr int kR = 32;           // kM = kR x kR: lanes x registers
constexpr int kWarps = 4;        // frames in flight per block
constexpr int kThreads = kWarps * 32;
constexpr int kExStride = kR + 1;             // exchange rows, float2
constexpr int kExFloat2 = kR * kExStride;     // >= kM: also holds Z
constexpr int kMagFloats = kM + 4;            // 1025 magnitudes, padded
// twiddle table (float2): W_32^j (j < 16), W_1024^(j k1) at [k1][j], then
// W_2048^f (f < 1024)
constexpr int kTw32 = 0;
constexpr int kTwMid = kR / 2;
constexpr int kTwSplit = kTwMid + kM;
constexpr int kTwFloat2 = kTwSplit + kM;

static_assert(kExFloat2 >= kM, "the exchange buffer holds Z");

__host__ __device__ constexpr int bitrev5(int i) {
  return ((i & 1) << 4) | ((i & 2) << 2) | (i & 4) | ((i & 8) >> 2) |
         ((i & 16) >> 4);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// One radix-2 decimation-in-frequency stage of a kR-point FFT in registers,
// then the next: pairs SPAN apart, twiddle W_{2 SPAN}^j = W_kR^(j kR / 2SPAN).
// After the last stage a[i] holds X[bitrev5(i)].
template <int SPAN>
__device__ __forceinline__ void dif_stages(float2 (&a)[kR],
                                           const float2* tw32) {
#pragma unroll
  for (int g0 = 0; g0 < kR; g0 += 2 * SPAN) {
#pragma unroll
    for (int j = 0; j < SPAN; ++j) {
      const float2 u = a[g0 + j], v = a[g0 + j + SPAN];
      a[g0 + j] = make_float2(u.x + v.x, u.y + v.y);
      const float2 d = make_float2(u.x - v.x, u.y - v.y);
      a[g0 + j + SPAN] = j == 0 ? d : cmul(d, tw32[j * (kR / (2 * SPAN))]);
    }
  }
  if constexpr (SPAN > 1) dif_stages<SPAN / 2>(a, tw32);
}

// shared memory: twiddles | window taps | band (start, length, offset) |
// per warp: exchange (float2) and magnitudes | bf16 weights
inline size_t smem_bytes(int taps, int n_mels, int nnz) {
  const size_t floats = 2 * kTwFloat2 + ((taps + 3) & ~3) +
                        ((3 * n_mels + 3) & ~3) +
                        kWarps * (2 * kExFloat2 + kMagFloats);
  return floats * 4 + static_cast<size_t>(nnz) * 2;
}

// kBands: mel bands per lane (n_mels <= 32 * kBands).
template <int kBands>
__global__ void __launch_bounds__(kThreads)
frame_mel_fft(const float* __restrict__ y, long long row_stride,
              long long total, int n_frames, int rows,
              const long long* __restrict__ frame_off,
              const long long* __restrict__ sample_off, int hop,
              const float* __restrict__ win, int first, int taps,
              const float2* __restrict__ tw, const int* __restrict__ band,
              const __nv_bfloat16* __restrict__ melw, int nnz, int n_mels,
              float ref_db, float max_db, float max_abs, int symmetric,
              float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float2* tw_s = reinterpret_cast<float2*>(smem);
  float* win_s = smem + 2 * kTwFloat2;
  int* band_s = reinterpret_cast<int*>(win_s + ((taps + 3) & ~3));
  float* warp_s = reinterpret_cast<float*>(band_s + ((3 * n_mels + 3) & ~3)) +
                  warp * (2 * kExFloat2 + kMagFloats);
  float2* ex = reinterpret_cast<float2*>(warp_s);
  float* mag = warp_s + 2 * kExFloat2;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<float*>(band_s + ((3 * n_mels + 3) & ~3)) +
      kWarps * (2 * kExFloat2 + kMagFloats));

  for (int i = tid; i < kTwFloat2; i += kThreads) tw_s[i] = tw[i];
  for (int i = tid; i < taps; i += kThreads) win_s[i] = win[i];
  for (int i = tid; i < 3 * n_mels; i += kThreads) band_s[i] = band[i];
  for (int i = tid; i < nnz; i += kThreads) w_s[i] = melw[i];
  __syncthreads();
  const float2* tw32 = tw_s + kTw32;

  for (long long gf = static_cast<long long>(blockIdx.x) * kWarps + warp;
       gf < total; gf += static_cast<long long>(gridDim.x) * kWarps) {
    const float* src;
    if (frame_off != nullptr) {   // ragged: the row r with frame_off[r] <= gf
      int lo = 0, hi = rows;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(frame_off + mid) <= gf) lo = mid; else hi = mid;
      }
      src = y + __ldg(sample_off + lo) + (gf - __ldg(frame_off + lo)) * hop;
    } else {
      const long long row = gf / n_frames;
      src = y + row * row_stride + (gf - row * n_frames) * hop;
    }

    // z_{32 n1 + lane} = x_2n + i x_2n+1, windowed; zero off the taps
    float2 a[kR];
#pragma unroll
    for (int n1 = 0; n1 < kR; ++n1) {
      const int k = 2 * (kR * n1 + lane);
      const unsigned o0 = static_cast<unsigned>(k - first);
      const unsigned o1 = o0 + 1u;
      a[n1] = make_float2(o0 < static_cast<unsigned>(taps)
                              ? src[k] * win_s[o0] : 0.f,
                          o1 < static_cast<unsigned>(taps)
                              ? src[k + 1] * win_s[o1] : 0.f);
    }
    // 32-point FFTs over n1, times W_1024^(lane k1), into rows k1
    dif_stages<kR / 2>(a, tw32);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int k1 = bitrev5(i);
      ex[k1 * kExStride + lane] =
          k1 == 0 ? a[i] : cmul(a[i], tw_s[kTwMid + k1 * kR + lane]);
    }
    __syncwarp();
    // 32-point FFTs over the lanes' index: lane k1 holds Z_{k1 + 32 k2}
#pragma unroll
    for (int n2 = 0; n2 < kR; ++n2) a[n2] = ex[lane * kExStride + n2];
    dif_stages<kR / 2>(a, tw32);
    __syncwarp();   // every row is read before Z overwrites it
#pragma unroll
    for (int i = 0; i < kR; ++i) ex[lane + kR * bitrev5(i)] = a[i];
    __syncwarp();

    // split step: X_f from Z_f and Z_{M-f}; magnitudes rounded to bf16
#pragma unroll 4
    for (int j = 0; j < kR; ++j) {
      const int f = lane + kR * j;
      const float2 zf = ex[f], zc = ex[(kM - f) & (kM - 1)];
      const float2 w = tw_s[kTwSplit + f];
      // even part (Z_f + conj Z_{M-f}) / 2, odd part (Z_f - conj Z_{M-f}) / 2i
      const float er = 0.5f * (zf.x + zc.x), ei = 0.5f * (zf.y - zc.y);
      const float orr = 0.5f * (zf.y + zc.y), oi = 0.5f * (zc.x - zf.x);
      const float re = er + (w.x * orr - w.y * oi);
      const float im = ei + (w.x * oi + w.y * orr);
      const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      mag[f] = __bfloat162float(__float2bfloat16_rn(__fsqrt_rn(p)));
    }
    if (lane == 0) {   // X_1024 = re Z_0 - im Z_0, real
      const float re = ex[0].x - ex[0].y;
      mag[kM] = __bfloat162float(
          __float2bfloat16_rn(__fsqrt_rn(__fmul_rn(re, re))));
    }
    __syncwarp();

    // mel bands over their nonzero weights, then dB and normalisation
    float* orow = out + gf * n_mels;
#pragma unroll
    for (int jb = 0; jb < kBands; ++jb) {
      const int m = lane + 32 * jb;
      if (m < n_mels) {
        const int start = band_s[m], len = band_s[n_mels + m],
                  off = band_s[2 * n_mels + m];
        float acc = 0.f;
        for (int i = 0; i < len; ++i)
          acc = fmaf(mag[start + i], __bfloat162float(w_s[off + i]), acc);
        const float db = 20.f * log10f(fmaxf(acc, 1e-5f));
        float v = fminf(fmaxf((db - ref_db + max_db) / max_db, 1e-8f), 1.f);
        if (symmetric) v = v * max_abs * 2.f - max_abs;
        orow[m] = v;
      }
    }
    __syncwarp();   // the buffers are read before the next frame
  }
}

template <int kBands>
cudaError_t launch(const float* y, long long total, long long row_stride,
                   int n_frames, int rows, const long long* frame_off,
                   const long long* sample_off, int hop, const float* win,
                   int first,
                   int taps, const float2* tw, const int* band,
                   const __nv_bfloat16* melw, int nnz, int n_mels,
                   float ref_db, float max_db, float max_abs, int symmetric,
                   float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(taps, n_mels, nnz);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      frame_mel_fft<kBands>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // as many blocks as fit on the card at once, each walking the frames
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, frame_mel_fft<kBands>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (total + kWarps - 1) / kWarps;
  const long long fit = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(want < fit ? want : fit);
  frame_mel_fft<kBands><<<blocks, kThreads, smem, stream>>>(
      y, row_stride, total, n_frames, rows, frame_off, sample_off, hop, win,
      first, taps, tw, band, melw, nnz, n_mels, ref_db, max_db, max_abs,
      symmetric, out);
  return cudaGetLastError();
}

}  // namespace

// Both layouts: y the reflect-padded signal (fp32; frame t of a row is its
// n_fft = 2048 samples from t * hop); win [taps] the window's nonzero taps,
// the first at offset `first` of the frame (first + taps <= 2048); tw [2064]
// float2, the twiddle table of ops/mel.py fft_twiddles; band [3][n_mels]
// int32: each band's first bin, bin count and offset into melw, its bf16
// weights (nnz in all).  n_mels <= 128.
static int run(const void* y, long long total, long long row_stride,
               int n_frames, int rows, const long long* frame_off,
               const long long* sample_off, int hop, const void* win,
               int first, int taps, const void* tw, const void* band,
               const void* melw, int nnz, int n_mels, float ref_db,
               float max_db, float max_abs, int symmetric, void* out,
               void* stream) {
  if (rows < 1 || total < 1 || hop < 1 || taps < 1 || first < 0 ||
      first + taps > kNfft || nnz < 0 || n_mels < 1 || n_mels > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(win);
  const float2* tf = static_cast<const float2*>(tw);
  const int* bf = static_cast<const int*>(band);
  const __nv_bfloat16* mf = static_cast<const __nv_bfloat16*>(melw);
  float* of = static_cast<float*>(out);
  const cudaError_t err =
      n_mels <= 96
          ? launch<3>(yf, total, row_stride, n_frames, rows, frame_off,
                      sample_off, hop, wf, first, taps, tf, bf, mf, nnz,
                      n_mels, ref_db, max_db, max_abs, symmetric, of, s)
          : launch<4>(yf, total, row_stride, n_frames, rows, frame_off,
                      sample_off, hop, wf, first, taps, tf, bf, mf, nnz,
                      n_mels, ref_db, max_db, max_abs, symmetric, of, s);
  return static_cast<int>(err);
}

// Rows of one width: y row 0, rows of row_stride samples, n_frames frames
// each; out [rows, n_frames, n_mels] fp32.
extern "C" int frame_mel(const void* y, int rows, long long row_stride,
                         int n_frames, int hop, const void* win, int first,
                         int taps, const void* tw, const void* band,
                         const void* melw, int nnz, int n_mels, float ref_db,
                         float max_db, float max_abs, int symmetric,
                         void* out, void* stream) {
  if (n_frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run(y, static_cast<long long>(rows) * n_frames, row_stride,
             n_frames, rows, nullptr, nullptr, hop, win, first, taps, tw,
             band, melw, nnz, n_mels, ref_db, max_db, max_abs, symmetric,
             out, stream);
}

// Ragged rows, on the device: frame_off [rows + 1] int64, rising from
// frame_off[0] = 0 to frame_off[rows] = total, and sample_off [rows] int64:
// row r's frame t starts at sample sample_off[r] + t * hop of y and is out
// row frame_off[r] + t; out [total, n_mels] fp32.  Every row has at least
// one frame.
extern "C" int frame_mel_ragged(const void* y, int rows, const void* frame_off,
                                const void* sample_off, long long total,
                                int hop, const void* win, int first, int taps,
                                const void* tw, const void* band,
                                const void* melw, int nnz, int n_mels,
                                float ref_db, float max_db, float max_abs,
                                int symmetric, void* out, void* stream) {
  if (frame_off == nullptr || sample_off == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(y, total, 0, 0, rows, static_cast<const long long*>(frame_off),
             static_cast<const long long*>(sample_off), hop, win, first,
             taps, tw, band, melw, nnz, n_mels, ref_db, max_db, max_abs,
             symmetric, out, stream);
}

extern "C" const char* frame_mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
