"""Audio DSP in numpy: mel extraction, mel -> Griffin-Lim waveform, wav
writing and silence trimming.

Own copy of ``few_shot_transformer_tts_tpu/ops/dsp.py`` with librosa-0.6
semantics (reference utils/audio.py:17-115).  Extraction: pre-emphasis ->
center/reflect STFT with a periodic Hann window -> magnitude -> Slaney mel
-> dB -> [-4, 4] (``get_spectrograms``).  Inversion: denormalize -> dB to
amplitude -> pinv mel basis -> Griffin-Lim (60 iterations, power 1.5) ->
de-emphasis (``mel2wav``).  This is the float64 golden reference of the
batched torch DSP in ``ops/dsp_torch.py`` and of the ``fused_frame_mel``
kernel (``ops/mel.py``); ``save_eval_results`` uses ``mel2wav`` per sample
on the CPU.  Wav reading (``load_wav``, polyphase ``resample_poly``) and
``trim_edges`` serve the corpus packer (``corpora/process_corpus.py``).
"""

from __future__ import annotations

import numpy as np

from ..config import Config

# ---------------------------------------------------------------------------
# windows / filterbanks
# ---------------------------------------------------------------------------


def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, as scipy.signal.get_window('hann', N)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def _hz_to_mel(freq):
    """Slaney mel scale (librosa htk=False): linear below 1 kHz, log above."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = freq >= min_log_hz
        mels[log_t] = min_log_mel + np.log(freq[log_t] / min_log_hz) / logstep
    elif freq >= min_log_hz:
        mels = min_log_mel + np.log(freq / min_log_hz) / logstep
    return mels


def _mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1 + n_fft//2).

    Matches ``librosa.filters.mel(sr, n_fft, n_mels)`` 0.6.0 defaults
    (htk=False, norm=1) used at reference utils/audio.py:14.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts.reshape(-1, 1) - fftfreqs.reshape(1, -1)

    weights = np.zeros((n_mels, n_freqs), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    # Slaney-style area normalization.
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, np.newaxis]
    return weights


# ---------------------------------------------------------------------------
# STFT / ISTFT (librosa-0.6 semantics: center=True, reflect pad, periodic Hann)
# ---------------------------------------------------------------------------


def _padded_window(win_length: int, n_fft: int) -> np.ndarray:
    win = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    return win


def frame_signal(y: np.ndarray, n_fft: int, hop_length: int,
                 center: bool = True) -> np.ndarray:
    """Slice y into overlapping frames of length n_fft -> (n_frames, n_fft)."""
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length) + np.arange(n_fft)[None, :]
    return y[idx]


def stft(y: np.ndarray, n_fft: int, hop_length: int, win_length: int,
         center: bool = True) -> np.ndarray:
    """Complex STFT, shape (1 + n_fft//2, n_frames)."""
    win = _padded_window(win_length, n_fft)
    frames = frame_signal(np.asarray(y, dtype=np.float64), n_fft, hop_length, center)
    spec = np.fft.rfft(frames * win[None, :], axis=-1)
    return spec.T


def istft(stft_matrix: np.ndarray, hop_length: int, win_length: int,
          center: bool = True) -> np.ndarray:
    """Inverse STFT by overlap-add with squared-window normalization."""
    n_fft = 2 * (stft_matrix.shape[0] - 1)
    n_frames = stft_matrix.shape[1]
    win = _padded_window(win_length, n_fft)

    expected_len = n_fft + hop_length * (n_frames - 1)
    y = np.zeros(expected_len, dtype=np.float64)
    win_sumsq = np.zeros(expected_len, dtype=np.float64)
    frames = np.fft.irfft(stft_matrix.T, n=n_fft, axis=-1)
    win_sq = win ** 2
    for i in range(n_frames):
        s = i * hop_length
        y[s:s + n_fft] += win * frames[i]
        win_sumsq[s:s + n_fft] += win_sq
    nz = win_sumsq > np.finfo(np.float64).tiny
    y[nz] /= win_sumsq[nz]
    if center:
        y = y[n_fft // 2: -(n_fft // 2)]
    return y


# ---------------------------------------------------------------------------
# mel extraction and inversion (reference utils/audio.py:17-92)
# ---------------------------------------------------------------------------

_mel_basis_cache = {}
_inv_mel_basis_cache = {}


def get_mel_basis(hp: Config) -> np.ndarray:
    key = (hp.sr, hp.n_fft, hp.num_mels)
    if key not in _mel_basis_cache:
        _mel_basis_cache[key] = mel_filterbank(hp.sr, hp.n_fft, hp.num_mels)
    return _mel_basis_cache[key]


def preemphasis(y: np.ndarray, coef: float) -> np.ndarray:
    """y[0], y[1:] - coef * y[:-1]."""
    return np.append(y[0], y[1:] - coef * y[:-1])


def deemphasis(y: np.ndarray, coef: float) -> np.ndarray:
    """Inverse of preemphasis: IIR filter 1/(1 - coef z^-1)."""
    from scipy.signal import lfilter
    return lfilter([1.0], [1.0, -coef], np.asarray(y, dtype=np.float64))


def normalize_mel_db(mel_db: np.ndarray, hp: Config) -> np.ndarray:
    """dB -> [1e-8, 1], then [-max_abs, max_abs] when symmetric."""
    mel = np.clip((mel_db - hp.ref_db + hp.max_db) / hp.max_db, 1e-8, 1)
    if hp.symmetric_mel:
        mel = mel * hp.max_abs_value * 2 - hp.max_abs_value
    return mel


def denormalize_mel(mel: np.ndarray, hp: Config) -> np.ndarray:
    if hp.symmetric_mel:
        mel = (mel + hp.max_abs_value) / (2 * hp.max_abs_value)
    return (np.clip(mel, 0, 1) * hp.max_db) - hp.max_db + hp.ref_db


def get_spectrograms(wav: np.ndarray, hp: Config) -> np.ndarray:
    """wav (normalized, trimmed) -> normalized mel, shape (T, n_mels)
    float32 (reference utils/audio.py:17-54)."""
    y = preemphasis(np.asarray(wav, dtype=np.float64), hp.preemphasis)
    linear = stft(y, hp.n_fft, hp.hop_length, hp.win_length)
    mag = np.abs(linear)                       # (1 + n_fft//2, T)
    mel = np.dot(get_mel_basis(hp), mag)       # (n_mels, T)
    mel = 20 * np.log10(np.maximum(1e-5, mel))
    return normalize_mel_db(mel, hp).T.astype(np.float32)


def mel_to_linear(mel: np.ndarray, hp: Config) -> np.ndarray:
    key = (hp.sr, hp.n_fft, hp.num_mels)
    if key not in _inv_mel_basis_cache:
        _inv_mel_basis_cache[key] = np.linalg.pinv(get_mel_basis(hp))
    return np.maximum(1e-10, np.dot(_inv_mel_basis_cache[key], mel))


def griffin_lim(spectrogram: np.ndarray, hp: Config) -> np.ndarray:
    """Griffin-Lim phase reconstruction (reference utils/audio.py:81-92)."""
    x_best = np.copy(spectrogram)
    for _ in range(hp.n_iter):
        x_t = istft(x_best, hp.hop_length, hp.win_length)
        est = stft(x_t, hp.n_fft, hp.hop_length, hp.win_length)
        phase = est / np.maximum(1e-8, np.abs(est))
        x_best = spectrogram * phase
    x_t = istft(x_best, hp.hop_length, hp.win_length)
    return np.real(x_t)


def mel2wav(mel: np.ndarray, hp: Config) -> np.ndarray:
    """Normalized mel (T, n_mels) -> waveform (reference utils/audio.py:63-79)."""
    mel = denormalize_mel(mel.T, hp)
    mel = np.power(10.0, mel * 0.05)           # db -> amplitude
    mag = mel_to_linear(mel, hp)
    if mag.shape[1] * hp.hop_length <= hp.n_fft:
        # too short to invert (center trim consumes n_fft samples)
        return np.zeros(max(1, mag.shape[1]) * hp.hop_length, dtype=np.float32)
    wav = griffin_lim(mag ** hp.power, hp)
    wav = deemphasis(wav, hp.preemphasis)
    return wav.astype(np.float32)


# ---------------------------------------------------------------------------
# wav io + silence handling (reference utils/audio.py:101-115)
# ---------------------------------------------------------------------------


def load_wav(path: str, sr: int = 16000) -> np.ndarray:
    """Load a wav file as float32 mono at the given sample rate."""
    from scipy.io import wavfile
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=-1)
    if file_sr != sr:
        data = resample_poly(data, sr, file_sr)
    return data


def resample_poly(y: np.ndarray, target_sr: int, source_sr: int) -> np.ndarray:
    from scipy import signal as sps
    from math import gcd
    g = gcd(target_sr, source_sr)
    return sps.resample_poly(y, target_sr // g, source_sr // g).astype(np.float32)


def save_wav(wav: np.ndarray, path: str, sr: int = 16000) -> str:
    """Peak-normalize and save as float32 wav (reference utils/audio.py:105-108)."""
    from scipy.io import wavfile
    wav_ = wav * 1 / max(0.01, np.max(np.abs(wav)))
    wavfile.write(path, sr, wav_.astype(np.float32))
    return path


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centered RMS per frame (librosa.feature.rms semantics, reflect pad)."""
    mode = "reflect" if len(y) > frame_length // 2 else "constant"
    y = np.pad(y, frame_length // 2, mode=mode)
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length) + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(y[idx] ** 2, axis=-1))


def split_intervals(y: np.ndarray, top_db: float, frame_length: int,
                    hop_length: int) -> np.ndarray:
    """Non-silent intervals [(start, end)] in samples (librosa.effects.split)."""
    rms = _frame_rms(y, frame_length, hop_length)
    power = rms ** 2
    ref = np.max(power)
    db = 10 * np.log10(np.maximum(power, 1e-20) / max(ref, 1e-20))
    non_silent = db > -top_db
    edges = np.flatnonzero(np.diff(non_silent.astype(np.int8)))
    starts, ends = [], []
    if non_silent[0]:
        starts.append(0)
    for e in edges:
        if non_silent[e + 1]:
            starts.append(e + 1)
        else:
            ends.append(e + 1)
    if non_silent[-1]:
        ends.append(len(non_silent))
    intervals = np.stack([np.asarray(starts), np.asarray(ends)], axis=-1) \
        if starts else np.zeros((0, 2), dtype=np.int64)
    intervals = intervals * hop_length
    intervals[:, 1] = np.minimum(intervals[:, 1], len(y))
    return intervals


def trim_silence_intervals(wav: np.ndarray, hp: Config) -> np.ndarray:
    """Concatenate voiced intervals (reference utils/audio.py:110-115)."""
    intervals = split_intervals(
        wav, top_db=50,
        frame_length=int(hp.sr / 1000 * hp.frame_length_ms) * 8,
        hop_length=int(hp.sr / 1000 * hp.frame_shift_ms))
    if len(intervals) == 0:
        return wav
    return np.concatenate([wav[l:r] for l, r in intervals])


def trim_edges(y: np.ndarray, top_db: float, frame_length: int,
               hop_length: int):
    """Leading/trailing silence trim (librosa.effects.trim): (trimmed, (l, r))."""
    intervals = split_intervals(y, top_db, frame_length, hop_length)
    if len(intervals) == 0:
        return y[0:0], (0, 0)
    l, r = int(intervals[0, 0]), int(intervals[-1, 1])
    return y[l:r], (l, r)
