"""Batched DSP in PyTorch on the caller's device; counterpart of
``few_shot_transformer_tts_tpu/ops/dsp_jax.py``, with its function names.

Framing is a strided view (``unfold``) of the reflect-padded signal, the
DFT runs through ``torch.fft`` (cuFFT on the card) or, for
``melspectrogram(use_pallas=True)``, through the ``fused_frame_mel`` kernel
(``ops/mel.py``).  Pre-emphasis is a difference; de-emphasis, the IIR
``out[n] = y[n] + c * out[n-1]``, a log-depth doubling scan (PyTorch has no
associative scan).  Griffin-Lim is a Python loop of batched STFT round
trips whose overlap-add is ``F.fold``: a gather, so on the card two calls
give the same bits, where a scatter-add (``index_add_``) would add with
atomics in a different order each time.  Everything is fp32; the numpy
``ops/dsp.py`` is the float64 golden reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from . import dsp

# ---------------------------------------------------------------------------
# elementwise / recurrence ops
# ---------------------------------------------------------------------------


def preemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    """y[0], y[1:] - coef*y[:-1] along the last axis."""
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


def deemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    """IIR 1/(1 - coef z^-1) along the last axis as a doubling scan.

    After the pass with shift d (1, 2, 4, ...) every out[n] holds
    sum_{j < 2d} coef^j y[n-j], so ceil(log2 L) passes give the recurrence
    out[n] = y[n] + coef * out[n-1] (18 passes for 10 s at 16 kHz)."""
    out = y
    c, d, n = float(coef), 1, y.shape[-1]
    while d < n:
        out = torch.cat([out[..., :d], out[..., d:] + c * out[..., :-d]],
                        dim=-1)
        c, d = c * c, 2 * d
    return out


# ---------------------------------------------------------------------------
# framing / STFT
# ---------------------------------------------------------------------------


_device_constants = {}


def device_constant(key, make, device, dtype=torch.float32) -> torch.Tensor:
    """``make()`` (a numpy array) as a ``dtype`` tensor on ``device``, copied
    once per (key, device): a copy from host memory waits for the device's
    queue, so constants are not copied per call or per iteration."""
    full = (key, str(device), dtype)
    if full not in _device_constants:
        _device_constants[full] = torch.from_numpy(
            np.ascontiguousarray(make())).to(device, dtype)
    return _device_constants[full]


def window(hp: Config, device) -> torch.Tensor:
    """The periodic Hann window of win_length centred in n_fft, fp32."""
    return device_constant(
        ("window", hp.win_length, hp.n_fft),
        lambda: dsp._padded_window(hp.win_length, hp.n_fft), device)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """[..., L] -> [..., n_frames, n_fft] overlapping frames (reflect-centred;
    a strided view of the padded signal).  Centring needs L > n_fft // 2."""
    if center:
        length = y.shape[-1]
        if length <= n_fft // 2:
            raise ValueError("reflect padding by %d needs more than %d "
                             "samples, got %d" % (n_fft // 2, n_fft // 2,
                                                  length))
        y = F.pad(y.reshape(-1, length), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(y.shape[:-1] + (-1,))
    return y.unfold(-1, n_fft, hop_length)


def stft(y: torch.Tensor, hp: Config) -> torch.Tensor:
    """Complex STFT [..., n_frames, 1 + n_fft//2] (frames axis first)."""
    frames = frame_signal(y, hp.n_fft, hp.hop_length) * window(hp, y.device)
    return torch.fft.rfft(frames, dim=-1)


def stft_mag(y: torch.Tensor, hp: Config) -> torch.Tensor:
    """[..., L] -> magnitude spectrogram [..., n_frames, 1 + n_fft//2]."""
    return stft(y, hp).abs()


def _ola_norm(n_frames: int, n_fft: int, hop: int,
              win_length: int) -> np.ndarray:
    """1 / the window's sum of squares over the overlap-add, float64 (1
    where the sum is 0), as ``dsp_jax.istft`` folds into a constant."""
    out_len = n_fft + hop * (n_frames - 1)
    win_sumsq = np.zeros(out_len, dtype=np.float64)
    wsq = dsp._padded_window(win_length, n_fft) ** 2
    for i in range(n_frames):
        win_sumsq[i * hop: i * hop + n_fft] += wsq
    norm = np.ones_like(win_sumsq)
    nz = win_sumsq > np.finfo(np.float64).tiny
    norm[nz] = 1.0 / win_sumsq[nz]
    return norm


def istft(spec: torch.Tensor, hp: Config) -> torch.Tensor:
    """Inverse STFT by overlap-add; spec is [..., n_frames, 1 + n_fft//2]."""
    n_fft, hop = hp.n_fft, hp.hop_length
    n_frames = spec.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window(hp, spec.device)
    # overlap-add: fold gathers each output sample's terms in a fixed order
    y = F.fold(frames.reshape(-1, n_frames, n_fft).transpose(1, 2),
               output_size=(1, out_len), kernel_size=(1, n_fft),
               stride=(1, hop))
    norm = device_constant(
        ("ola_norm", n_frames, n_fft, hop, hp.win_length),
        lambda: _ola_norm(n_frames, n_fft, hop, hp.win_length), spec.device)
    y = y.reshape(spec.shape[:-2] + (out_len,)) * norm
    return y[..., n_fft // 2: out_len - n_fft // 2]


# ---------------------------------------------------------------------------
# mel extraction
# ---------------------------------------------------------------------------


def normalize_db(mel: torch.Tensor, hp: Config) -> torch.Tensor:
    """Linear mel -> 20 log10(max(1e-5, mel)) -> clip-normalised
    [1e-8, 1], then [-max_abs, max_abs] when symmetric."""
    db = 20.0 * torch.log10(torch.clamp(mel, min=1e-5))
    out = torch.clamp((db - hp.ref_db + hp.max_db) / hp.max_db, 1e-8, 1.0)
    if hp.symmetric_mel:
        out = out * hp.max_abs_value * 2 - hp.max_abs_value
    return out


def melspectrogram(wav: torch.Tensor, hp: Config,
                   use_pallas: bool = False) -> torch.Tensor:
    """Batched wav [..., L] -> normalised mel [..., T, n_mels] on wav's
    device (``dsp.get_spectrograms`` elementwise).

    ``use_pallas`` (the JAX package's name) routes to the
    ``fused_frame_mel`` kernel; otherwise the DFT is ``torch.fft.rfft`` and
    the mel product fp32."""
    y = preemphasis(wav.float(), hp.preemphasis)
    if use_pallas:
        from .mel import fused_frame_mel
        return fused_frame_mel(y, hp)
    basis = device_constant(("mel_basis", hp.sr, hp.n_fft, hp.num_mels),
                            lambda: dsp.get_mel_basis(hp).T, y.device)
    return normalize_db(stft_mag(y, hp) @ basis, hp)        # [..., T, M]


def pack_ragged(wavs, hp: Config):
    """Utterances of different lengths (1-D tensors) -> (signal [N] fp32,
    starts, frames), the layout of ``fused_frame_mel_ragged``: each
    pre-emphasised and reflect-padded by n_fft // 2 on its own, as
    ``melspectrogram`` does for one row, then put one after another; row
    r starts at sample starts[r] and has frames[r] = 1 + L // hop frames."""
    half = hp.n_fft // 2
    rows, starts, frames, at = [], [], [], 0
    for w in wavs:
        if w.shape[0] <= half:
            raise ValueError("reflect padding by %d needs more than %d "
                             "samples, got %d" % (half, half, w.shape[0]))
        y = preemphasis(w.float(), hp.preemphasis)
        rows.append(F.pad(y[None], (half, half), mode="reflect")[0])
        starts.append(at)
        frames.append(1 + w.shape[0] // hp.hop_length)
        at += rows[-1].shape[0]
    return torch.cat(rows), starts, frames


def melspectrogram_ragged(wavs, hp: Config, device) -> list:
    """Sibling of ``melspectrogram(use_pallas=True)`` for utterances of
    different lengths: 1-D wav tensors on the host -> one mel [1 + L // hop,
    n_mels] each, on the host, through one ``fused_frame_mel_ragged`` call on
    ``device`` (one kernel launch on a CUDA device; the plain version on the
    CPU).  The kernel gives each utterance the mel that
    ``melspectrogram(use_pallas=True)`` gives it alone."""
    from .mel import fused_frame_mel_ragged
    signal, starts, frames = pack_ragged(wavs, hp)
    mel = fused_frame_mel_ragged(signal.to(device), starts, frames, hp)
    return list(mel.cpu().split(frames))


# ---------------------------------------------------------------------------
# Griffin-Lim vocoder (batched, on the device)
# ---------------------------------------------------------------------------


def griffin_lim(mag: torch.Tensor, hp: Config) -> torch.Tensor:
    """Batched Griffin-Lim: mag [..., T, F] -> wav [..., (T - 1) * hop].

    The reference's ``n_iter`` magnitude projections (utils/audio.py:81-92)
    as batched STFT round trips."""
    x_best = mag.to(torch.complex64)
    for _ in range(hp.n_iter):
        est = stft(istft(x_best, hp), hp)
        x_best = mag * (est / torch.clamp(est.abs(), min=1e-8))
    return istft(x_best, hp)


def mel2wav(mel: torch.Tensor, hp: Config) -> torch.Tensor:
    """Batched normalised mel [..., T, M] -> wav (reference
    utils/audio.py:63-79) on mel's device."""
    m = mel.float()
    if hp.symmetric_mel:
        m = (m + hp.max_abs_value) / (2 * hp.max_abs_value)
    db = torch.clamp(m, 0, 1) * hp.max_db - hp.max_db + hp.ref_db
    amp = torch.pow(10.0, db * 0.05)                        # [..., T, M]
    inv_basis = device_constant(                            # [M, F]
        ("inv_mel_basis", hp.sr, hp.n_fft, hp.num_mels),
        lambda: np.linalg.pinv(dsp.get_mel_basis(hp)).T, mel.device)
    mag = torch.clamp(amp @ inv_basis, min=1e-10)
    return deemphasis(griffin_lim(mag ** hp.power, hp), hp.preemphasis)
