"""The fused STFT -> mel kernel; counterpart of
``few_shot_transformer_tts_tpu/ops/mel_pallas.py`` (``fused_frame_mel``).

One pass from the pre-emphasised signal to the normalised mel:

  windowed frames @ cos / sin (fp32) -> magnitude -> rounded to bf16
  -> @ mel weights (bf16 values, fp32 sums) -> 20 log10(max(1e-5, .))
  -> clip-normalise -> [-4, 4]

The DFT stays fp32 (no TF32, no tensor cores): quiet bins come from
near-total cancellation of large terms.  The bf16 rounding of the magnitude
and of the mel weights is part of the function, as in the TPU kernel.

``fused_frame_mel(y, hp)`` takes the signal and reflect-pads each row;
``fused_frame_mel_ragged(signal, starts, frames, hp)`` takes rows of
different lengths, already padded, one after another in one signal, each
with its own frame count (the corpus packer's batches: each utterance
reflect-padded on its own).  For CUDA tensors they launch
``csrc/frame_mel.cu``, which reads the padded signal and applies
the window itself (the [BT, n_fft] frames and the [BT, F] magnitude never
reach device memory) and computes the spectrum with a real FFT per frame
(n_fft = 2048: a 32 x 32 four-step complex FFT of 1024 points and the
real-FFT split step, twiddles from ``fft_twiddles``), then the mel product
over the filterbank's nonzero weights (``mel_bands``); for CPU tensors they
frame in PyTorch and take ``fused_frame_mel_plain``, the same math on
windowed frames with the DFT as a product (also what the tests and
``chip_smoke.py`` hold the kernel against).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from . import cuda_build, dsp
from .dsp_torch import device_constant, frame_signal, normalize_db, window

FREQ_TILE = 64        # the DFT tables' frequencies are padded to it
FFT_SIZE = 2048       # the n_fft the kernel's FFT takes
_MAX_MELS = 128


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=4)
def _mats(sr: int, n_fft: int, n_mels: int):
    n_freqs = 1 + n_fft // 2
    f_pad = _round_up(n_freqs, FREQ_TILE)
    k = np.arange(n_fft)[:, None]
    f = np.arange(f_pad)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    cos[:, n_freqs:] = 0.0
    sin[:, n_freqs:] = 0.0
    mel_w = np.zeros((f_pad, n_mels))
    mel_w[:n_freqs] = dsp.mel_filterbank(sr, n_fft, n_mels).T
    return (cos.astype(np.float32), sin.astype(np.float32),
            mel_w.astype(np.float32))


def dft_mel_mats(hp: Config):
    """(cos [n_fft, Fpad], sin [n_fft, Fpad], mel weights [Fpad, n_mels]),
    float32 numpy built in float64 as the TPU kernel's ``_dft_mel_mats``;
    Fpad is 1 + n_fft // 2 rounded up to FREQ_TILE, the padding zero."""
    return _mats(hp.sr, hp.n_fft, hp.num_mels)


@functools.lru_cache(maxsize=2)
def fft_twiddles(n_fft: int = FFT_SIZE) -> np.ndarray:
    """The kernel's twiddle table, [16 + n_fft, 2] fp32 (re, im) built in
    float64 and rounded once: W_32^j for j < 16 (the 32-point FFTs), then
    W_{n_fft/2}^(j k1) at 16 + 32 k1 + j for j, k1 < 32 (the four-step
    twiddles), then W_{n_fft}^f for f < n_fft / 2 (the real-FFT split
    step); W_N^m = exp(-2 pi i m / N)."""
    if n_fft != FFT_SIZE:
        raise ValueError("the kernel's FFT takes n_fft %d, got %d"
                         % (FFT_SIZE, n_fft))
    m = n_fft // 2
    j = np.arange(32)
    ang = np.concatenate([
        -2.0 * np.pi * np.arange(16) / 32,
        -2.0 * np.pi * (np.outer(j, j) % m).reshape(-1) / m,
        -2.0 * np.pi * np.arange(m) / n_fft])
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _bands(sr: int, n_fft: int, n_mels: int):
    w = _mats(sr, n_fft, n_mels)[2]
    w = torch.from_numpy(w).to(torch.bfloat16)
    starts, lengths, weights = [], [], []
    for m in range(n_mels):
        nz = torch.nonzero(w[:, m]).reshape(-1)
        first = int(nz[0]) if len(nz) else 0
        count = int(nz[-1]) + 1 - first if len(nz) else 0
        starts.append(first)
        lengths.append(count)
        weights.append(w[first:first + count, m])
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return (np.stack([starts, lengths, offsets]).astype(np.int32),
            torch.cat(weights))


def mel_bands(hp: Config):
    """The filterbank's nonzero weights, as the kernel takes them: (band
    [3, n_mels] int32 numpy, each band's first bin, bin count and offset
    into the weights; weights, a bf16 tensor of every band's bins in
    order), from ``dft_mel_mats``' weights rounded to bf16 (the values the
    plain version multiplies by)."""
    return _bands(hp.sr, hp.n_fft, hp.num_mels)


def _taps(hp: Config):
    """(first, count) of the window's nonzero taps."""
    nz = np.flatnonzero(dsp._padded_window(hp.win_length, hp.n_fft))
    return int(nz[0]), int(nz[-1] + 1 - nz[0])


def _on_device(hp: Config, device) -> dict:
    """The plain version's tables on ``device`` (each copied once): cos/sin
    fp32 and the mel weights bf16."""
    key = (hp.sr, hp.n_fft, hp.num_mels, hp.win_length)
    mats = lambda i: (lambda: dft_mel_mats(hp)[i])
    return {
        "cos": device_constant(("dft_cos",) + key, mats(0), device),
        "sin": device_constant(("dft_sin",) + key, mats(1), device),
        "mel_w": device_constant(("dft_mel_w",) + key, mats(2), device,
                                 torch.bfloat16)}


def _kernel_tables(hp: Config, device) -> dict:
    """The kernel's tables on ``device`` (each copied once): the window's
    nonzero taps, the twiddles and the sparse mel bands."""
    key = (hp.sr, hp.n_fft, hp.num_mels, hp.win_length)
    first, count = _taps(hp)
    return {
        "win_taps": device_constant(
            ("win_taps",) + key, lambda: dsp._padded_window(
                hp.win_length, hp.n_fft)[first:first + count], device),
        "twiddles": device_constant(("fft_twiddles", hp.n_fft),
                                    lambda: fft_twiddles(hp.n_fft), device),
        "band": device_constant(("mel_band",) + key,
                                lambda: mel_bands(hp)[0], device,
                                torch.int32),
        "band_w": device_constant(
            ("mel_band_w",) + key,
            lambda: mel_bands(hp)[1].float().numpy(), device, torch.bfloat16),
        "first": first, "count": count}


def windowed_frames(y: torch.Tensor, hp: Config) -> torch.Tensor:
    """Signal [..., L] -> windowed frames [..., T, n_fft] fp32 (the TPU
    kernel's input)."""
    return frame_signal(y.float(), hp.n_fft, hp.hop_length) * \
        window(hp, y.device)


def fused_frame_mel_plain(frames: torch.Tensor, hp: Config) -> torch.Tensor:
    """Plain PyTorch version of the kernel: windowed frames [..., n_fft]
    fp32 -> normalised mel [..., n_mels], with the TPU kernel's rounding
    points (fp32 DFT; magnitude and mel weights rounded to bf16, whose
    products are exact in fp32, summed in fp32)."""
    m = _on_device(hp, frames.device)
    re = frames @ m["cos"]
    im = frames @ m["sin"]
    mag = torch.sqrt(re * re + im * im)
    mel = mag.to(torch.bfloat16).float() @ m["mel_w"].float()
    return normalize_db(mel, hp)


def _check_kernel_config(hp: Config):
    if not 1 <= hp.num_mels <= _MAX_MELS:
        raise ValueError("the kernel takes 1 to %d mels, got %d"
                         % (_MAX_MELS, hp.num_mels))
    if hp.n_fft != FFT_SIZE:
        raise ValueError("the kernel's FFT takes n_fft %d, got %d"
                         % (FFT_SIZE, hp.n_fft))


def _launch_error(lib, err):
    if err != 0:
        raise RuntimeError("frame_mel launch failed: %s"
                           % lib.frame_mel_error_string(err).decode())


def _table_args(m: dict, hp: Config) -> tuple:
    return (hp.hop_length, m["win_taps"].data_ptr(), m["first"], m["count"],
            m["twiddles"].data_ptr(), m["band"].data_ptr(),
            m["band_w"].data_ptr(), m["band_w"].numel(), hp.num_mels,
            float(hp.ref_db), float(hp.max_db), float(hp.max_abs_value),
            int(bool(hp.symmetric_mel)))


def fused_frame_mel(y: torch.Tensor, hp: Config) -> torch.Tensor:
    """Pre-emphasised signal [..., L] -> normalised mel [..., T, n_mels],
    T = 1 + L // hop.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if y.device.type == "cpu":
        return fused_frame_mel_plain(windowed_frames(y, hp), hp)
    if y.device.type != "cuda":
        raise ValueError("fused_frame_mel runs on CPU or CUDA tensors, not "
                         "%s" % y.device)
    _check_kernel_config(hp)
    length = y.shape[-1]
    half = hp.n_fft // 2
    if length <= half:
        raise ValueError("reflect padding by %d needs more than %d samples, "
                         "got %d" % (half, half, length))
    rows = y.reshape(-1, length).float()
    padded = F.pad(rows, (half, half), mode="reflect").contiguous()
    n_frames = 1 + (padded.shape[1] - hp.n_fft) // hp.hop_length
    m = _kernel_tables(hp, y.device)
    out = torch.empty((rows.shape[0], n_frames, hp.num_mels),
                      dtype=torch.float32, device=y.device)
    if rows.shape[0]:
        lib = _library()
        _launch_error(lib, lib.frame_mel(
            padded.data_ptr(), rows.shape[0], padded.shape[1], n_frames,
            *_table_args(m, hp), out.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream))
        fused_frame_mel.launches += 1
    return out.reshape(y.shape[:-1] + (n_frames, hp.num_mels))


def _ragged_frame_offsets(signal: torch.Tensor, starts, frames,
                          hp: Config) -> list:
    """[0, frames[0], frames[0] + frames[1], ...] after checking that every
    row's frames lie inside the signal."""
    if signal.dim() != 1 or len(starts) != len(frames) or not len(frames):
        raise ValueError("a ragged call takes a 1-D signal and one start "
                         "and one frame count per row, got %s, %d, %d"
                         % (tuple(signal.shape), len(starts), len(frames)))
    offsets = [0]
    for s, t in zip(starts, frames):
        if t < 1 or s < 0 or \
                s + (t - 1) * hp.hop_length + hp.n_fft > signal.shape[0]:
            raise ValueError("a row of %d frames from sample %d does not fit "
                             "a signal of %d samples" % (t, s,
                                                         signal.shape[0]))
        offsets.append(offsets[-1] + int(t))
    return offsets


def fused_frame_mel_ragged_plain(signal: torch.Tensor, starts, frames,
                                 hp: Config) -> torch.Tensor:
    """Plain version of ``fused_frame_mel_ragged``: each row's frames
    (strided views), windowed, concatenated and through
    ``fused_frame_mel_plain``."""
    _ragged_frame_offsets(signal, starts, frames, hp)
    win = window(hp, signal.device)
    framed = torch.cat([
        signal[s:s + (t - 1) * hp.hop_length + hp.n_fft].float().unfold(
            0, hp.n_fft, hp.hop_length) for s, t in zip(starts, frames)])
    return fused_frame_mel_plain(framed * win, hp)


def fused_frame_mel_ragged(signal: torch.Tensor, starts, frames,
                           hp: Config) -> torch.Tensor:
    """Rows of different lengths in one signal [N] fp32, each already
    padded, -> their mels packed, [sum(frames), n_mels]: row r's frame t is
    the samples starts[r] + t * hop to that + n_fft, and is output row
    frames[0] + ... + frames[r - 1] + t.  An utterance pre-emphasised and
    reflect-padded by n_fft // 2 on its own, with 1 + L // hop frames, gets
    the mel ``fused_frame_mel`` gives it alone; no frame past a row's end is
    computed.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (one launch) or raise."""
    if signal.device.type == "cpu":
        return fused_frame_mel_ragged_plain(signal, starts, frames, hp)
    if signal.device.type != "cuda":
        raise ValueError("fused_frame_mel runs on CPU or CUDA tensors, not "
                         "%s" % signal.device)
    _check_kernel_config(hp)
    frame_off = _ragged_frame_offsets(signal, starts, frames, hp)
    rows = len(frames)
    signal = signal.float().contiguous()
    # frame offsets [rows + 1] then sample offsets [rows], one copy from
    # pinned memory that does not wait for the stream
    offs = torch.tensor(frame_off + [int(s) for s in starts],
                        dtype=torch.int64).pin_memory().to(
                            signal.device, non_blocking=True)
    m = _kernel_tables(hp, signal.device)
    out = torch.empty((frame_off[-1], hp.num_mels), dtype=torch.float32,
                      device=signal.device)
    lib = _library()
    _launch_error(lib, lib.frame_mel_ragged(
        signal.data_ptr(), rows, offs.data_ptr(), offs[rows + 1:].data_ptr(),
        frame_off[-1], *_table_args(m, hp), out.data_ptr(),
        torch.cuda.current_stream(signal.device).cuda_stream))
    fused_frame_mel.launches += 1
    return out


# Kernel launches since the count was last reset (chip_smoke.py reads it).
fused_frame_mel.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("frame_mel")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.frame_mel.argtypes = [p, i, ctypes.c_longlong, i, i, p, i, i, p, p,
                              p, i, i, f, f, f, i, p, p]
    lib.frame_mel.restype = i
    lib.frame_mel_ragged.argtypes = [p, i, p, p, ctypes.c_longlong, i, p, i,
                                     i, p, p, p, i, i, f, f, f, i, p, p]
    lib.frame_mel_ragged.restype = i
    lib.frame_mel_error_string.argtypes = [i]
    lib.frame_mel_error_string.restype = ctypes.c_char_p
    return lib
