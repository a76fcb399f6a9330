// Fused STFT -> mel for Hopper (sm_90a): pre-emphasised signal to the
// normalised mel in one pass.
//
// Replaces the TPU kernel `fused_frame_mel`
// (few_shot_transformer_tts_tpu/ops/mel_pallas.py, body `_mel_kernel`).  Per
// frame t of a row (n_fft samples from t * hop of the reflect-padded signal,
// times the Hann window):
//
//   re_f, im_f = sum_k x_k cos / sin(-2 pi k f / n_fft)       (fp32)
//   mag_f      = bf16(sqrt(re_f^2 + im_f^2))                   (bf16 value)
//   mel_m      = sum_f mag_f * W_fm          (W bf16 values, fp32 sums)
//   out_m      = clip((20 log10(max(1e-5, mel_m)) - ref + max) / max,
//                     1e-8, 1) * 2 max_abs - max_abs           (symmetric)
//
// Design.  The TPU kernel takes framed, windowed rows and walks the
// frequency tiles in order, accumulating the mel block in its output.  Here
// a block owns 64 consecutive frames of one row and loops over every
// frequency tile itself, so nothing crosses blocks:
//   * the block stages its stretch of the padded signal (63 hops plus the
//     window's nonzero taps, 53.6 KB at hop 200) in shared memory once, and
//     builds each 32-tap chunk of windowed frames from it, so the 10x
//     overlapping [T, n_fft] frame tensor is never written anywhere;
//   * only the window's nonzero taps are summed (799 of 2048 at the default
//     config; the others add exact zeros), with the cos/sin table rows of
//     those taps staged 32 x 64 at a time;
//   * 256 threads each hold 4 frames x 4 frequencies of re and im (fp32
//     FMA, the table values rounded to fp32 once, as in the TPU kernel);
//   * after a 64-frequency tile the magnitudes go to shared memory rounded
//     to bf16, and each thread adds them into 20 mel sums of one frame
//     (fp32), so the [T, 1025] magnitude never reaches device memory;
//   * the dB / normalise epilogue runs on the mel sums in registers.
// About 108 KB of shared memory: two blocks per SM.
//
// Bound.  The DFT over the nonzero taps: 2 products x 2 x BT x 799 x 1025
// flops (42 GFLOP for 16 rows of 10 s), 0.63 ms at 67 TFLOP/s fp32; the
// bytes (the signal read once, the mel written once, 14 MB) take 4 us.  So
// the fp32 FMA pipes bound it; an FFT would need about 60x fewer operations
// but sums in another order than the TPU kernel's matrix products.
//
// Interface: a plain C entry, built by nvcc into a shared library and loaded
// with ctypes (few_shot_transformer_tts_torch/ops/cuda_build.py).  It
// launches on the given stream, allocates nothing and returns the launch
// error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTM = 64;       // frames per block
constexpr int kTF = 64;       // frequencies per tile
constexpr int kKC = 32;       // taps per chunk
constexpr int kThreads = 256;
constexpr int kXStride = kTM + 1;   // xs rows, padded against bank conflicts
constexpr int kMStride = kTF + 1;   // mag rows

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// the stretch of signal a block reads: its 64 frames' taps, rounded up to
// whole chunks (the padding reads zeros)
__host__ __device__ inline int seg_floats(int hop, int taps) {
  return round_up((kTM - 1) * hop + round_up(taps, kKC), 4);
}

// shared memory: seg | win | xs | cos | sin | mag (floats) | mel weights
// (bf16)
inline size_t smem_bytes(int hop, int taps, int n_mels) {
  const int floats = seg_floats(hop, taps) + round_up(taps, kKC) +
                     kKC * kXStride + 2 * kKC * kTF + kTM * kMStride;
  return static_cast<size_t>(round_up(floats, 4)) * 4 +
         static_cast<size_t>(kTF) * n_mels * 2;
}

// kMels: mel sums per thread (n_mels <= 4 * kMels).
template <int kMels>
__global__ void __launch_bounds__(kThreads, 2)
frame_mel_kernel(const float* __restrict__ y, long long row_stride,
                 int n_frames, int hop, const float* __restrict__ win,
                 int taps, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, int f_pad,
                 const __nv_bfloat16* __restrict__ melw, int n_mels,
                 float ref_db, float max_db, float max_abs, int symmetric,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int row = blockIdx.y;
  const int t0 = blockIdx.x * kTM;
  const int seg_len = seg_floats(hop, taps);
  const int taps_pad = round_up(taps, kKC);
  float* seg = smem;                      // [seg_len]
  float* win_s = seg + seg_len;           // [taps_pad], zero beyond taps
  float* xs = win_s + taps_pad;           // [kKC][kXStride] windowed frames
  float* cs = xs + kKC * kXStride;        // [kKC][kTF]
  float* sn = cs + kKC * kTF;             // [kKC][kTF]
  float* mag = sn + kKC * kTF;            // [kTM][kMStride]
  __nv_bfloat16* mw = reinterpret_cast<__nv_bfloat16*>(
      smem + round_up(seg_len + taps_pad + kKC * kXStride + 2 * kKC * kTF +
                          kTM * kMStride, 4));   // [kTF][n_mels]

  // the block's stretch of the signal; samples past the last frame read 0
  const float* yrow = y + row * row_stride;
  const int base = t0 * hop;
  const int limit = (n_frames - 1) * hop + taps;
  for (int i = tid; i < seg_len; i += kThreads)
    seg[i] = base + i < limit ? yrow[base + i] : 0.f;
  for (int k = tid; k < taps_pad; k += kThreads)
    win_s[k] = k < taps ? win[k] : 0.f;

  const int tx = tid & 15, ty = tid >> 4;   // DFT: frames ty*4+i, freqs tx+16j
  const int mf = tid >> 2, mg = tid & 3;    // mel: frame mf, mels mg+4j
  float acc[kMels];
#pragma unroll
  for (int j = 0; j < kMels; ++j) acc[j] = 0.f;

  for (int f0 = 0; f0 < f_pad; f0 += kTF) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int k0 = 0; k0 < taps; k0 += kKC) {
      __syncthreads();   // the previous chunk (and the staging) is done
      // windowed frames of the chunk: consecutive threads take consecutive
      // taps of one frame
      for (int i = tid; i < kKC * kTM; i += kThreads) {
        const int f = i / kKC, k = i % kKC;
        xs[k * kXStride + f] = seg[f * hop + k0 + k] * win_s[k0 + k];
      }
      for (int i = tid; i < kKC * kTF / 4; i += kThreads) {
        const int k = i / (kTF / 4), c = (i % (kTF / 4)) * 4;
        float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), sv = cv;
        if (k0 + k < taps) {
          const long long off = (long long)(k0 + k) * f_pad + f0 + c;
          cv = *reinterpret_cast<const float4*>(cos_t + off);
          sv = *reinterpret_cast<const float4*>(sin_t + off);
        }
        *reinterpret_cast<float4*>(cs + k * kTF + c) = cv;
        *reinterpret_cast<float4*>(sn + k * kTF + c) = sv;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        float xv[4], cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[k * kXStride + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cv[j] = cs[k * kTF + tx + 16 * j];
          sv[j] = sn[k * kTF + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(xv[i], cv[j], re[i][j]);
            im[i][j] = fmaf(xv[i], sv[j], im[i][j]);
          }
      }
    }

    // magnitudes rounded to bf16 (separate roundings of re^2, im^2 and the
    // sum, as the plain version's tensor ops), and the tile's mel weights
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __fadd_rn(__fmul_rn(re[i][j], re[i][j]),
                                  __fmul_rn(im[i][j], im[i][j]));
        mag[(ty * 4 + i) * kMStride + tx + 16 * j] =
            __bfloat162float(__float2bfloat16_rn(__fsqrt_rn(p)));
      }
    for (int i = tid; i < kTF * n_mels; i += kThreads)
      mw[i] = melw[(long long)f0 * n_mels + i];
    __syncthreads();
#pragma unroll 4
    for (int fq = 0; fq < kTF; ++fq) {
      const float mv = mag[mf * kMStride + fq];
#pragma unroll
      for (int j = 0; j < kMels; ++j) {
        const int m = mg + 4 * j;
        if (m < n_mels)
          acc[j] = fmaf(mv, __bfloat162float(mw[fq * n_mels + m]), acc[j]);
      }
    }
  }

  const int t = t0 + mf;
  if (t >= n_frames) return;
  float* orow = out + ((long long)row * n_frames + t) * n_mels;
#pragma unroll
  for (int j = 0; j < kMels; ++j) {
    const int m = mg + 4 * j;
    if (m >= n_mels) continue;
    const float db = 20.f * log10f(fmaxf(acc[j], 1e-5f));
    float v = fminf(fmaxf((db - ref_db + max_db) / max_db, 1e-8f), 1.f);
    if (symmetric) v = v * max_abs * 2.f - max_abs;
    orow[m] = v;
  }
}

template <int kMels>
cudaError_t launch(const float* y, int rows, long long row_stride,
                   int n_frames, int hop, const float* win, int taps,
                   const float* cos_t, const float* sin_t, int f_pad,
                   const __nv_bfloat16* melw, int n_mels, float ref_db,
                   float max_db, float max_abs, int symmetric, float* out,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(hop, taps, n_mels);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      frame_mel_kernel<kMels>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + kTM - 1) / kTM, rows);
  frame_mel_kernel<kMels><<<grid, kThreads, smem, stream>>>(
      y, row_stride, n_frames, hop, win, taps, cos_t, sin_t, f_pad, melw,
      n_mels, ref_db, max_db, max_abs, symmetric, out);
  return cudaGetLastError();
}

}  // namespace

// y: the first nonzero window tap of row 0 of the reflect-padded signal
// (fp32, rows of row_stride samples; frame t of a row starts at t * hop);
// win [taps] the window's nonzero taps; cos_t, sin_t [taps, f_pad] the DFT
// table rows of those taps (f_pad a multiple of 64, 16-byte aligned); melw
// [f_pad, n_mels] bf16; out [rows, n_frames, n_mels] fp32.  n_mels <= 128,
// rows <= 65535.
extern "C" int frame_mel(const void* y, int rows, long long row_stride,
                         int n_frames, int hop, const void* win, int taps,
                         const void* cos_t, const void* sin_t, int f_pad,
                         const void* melw, int n_mels, float ref_db,
                         float max_db, float max_abs, int symmetric,
                         void* out, void* stream) {
  if (rows < 1 || rows > 65535 || n_frames < 1 || hop < 1 || taps < 1 ||
      f_pad < kTF || f_pad % kTF != 0 || n_mels < 1 || n_mels > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* wf = static_cast<const float*>(win);
  const float* cf = static_cast<const float*>(cos_t);
  const float* sf = static_cast<const float*>(sin_t);
  const __nv_bfloat16* mf = static_cast<const __nv_bfloat16*>(melw);
  float* of = static_cast<float*>(out);
  const cudaError_t err =
      n_mels <= 80
          ? launch<20>(yf, rows, row_stride, n_frames, hop, wf, taps, cf, sf,
                       f_pad, mf, n_mels, ref_db, max_db, max_abs, symmetric,
                       of, s)
          : launch<32>(yf, rows, row_stride, n_frames, hop, wf, taps, cf, sf,
                       f_pad, mf, n_mels, ref_db, max_db, max_abs, symmetric,
                       of, s);
  return static_cast<int>(err);
}

extern "C" const char* frame_mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
