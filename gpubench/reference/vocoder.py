"""Griffin-Lim judged by what any sound Griffin-Lim gives, in float64.

The program vocodes a mel by 60 Griffin-Lim iterations from zero phase.
Those iterations carry every change of rounding into the phase, so no
second implementation gives its waveform back: a float64 run and a sound
float32 one end up as far apart as one with every spectrum in bf16.  What
they share is what Griffin-Lim is for, a waveform whose spectrum has the
magnitude that the mel asks for.  So the check holds the program's
waveform to that, with nothing taken from the program:

* the magnitude the mel asks for: the mel de-normalised to amplitude,
  through the pseudo-inverse of a Slaney mel filterbank built here, to
  the power ``hp.power`` (the reference implementation's ``mel2wav``);
* the program's waveform with its de-emphasis undone (the FIR
  pre-emphasis), its STFT magnitude (librosa 0.6's conventions: a periodic
  Hann window of ``win_length`` centred in ``n_fft``, reflect-padded
  frames), and its spectral convergence against that magnitude;
* the same for this module's own float64 Griffin-Lim of the same mel
  (overlap-add inverse, the same iterations), which gives the floor that
  Griffin-Lim reaches on that mel.

Everything here is float64.  ``round_to`` rounds every spectrum and
waveform of the iterations to a lower type (the control).
"""

from __future__ import annotations

import numpy as np
import torch

_F_SP = 200.0 / 3              # Hz a mel below the break (Slaney)
_BREAK_HZ = 1000.0
_LOGSTEP = np.log(6.4) / 27.0  # log-Hz a mel above it


def hz_to_mel(f):
    f = np.asarray(f, np.float64)
    above = _BREAK_HZ / _F_SP + np.log(np.maximum(f, _BREAK_HZ) /
                                       _BREAK_HZ) / _LOGSTEP
    return np.where(f < _BREAK_HZ, f / _F_SP, above)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    brk = _BREAK_HZ / _F_SP
    return np.where(m < brk, m * _F_SP,
                    _BREAK_HZ * np.exp(_LOGSTEP * (np.maximum(m, brk) -
                                                   brk)))


def mel_filterbank(sr, n_fft, n_mels) -> np.ndarray:
    """Slaney-normalised triangles (each of area-normalised height 2 / its
    width in Hz) on the bins k sr / n_fft: [n_mels, 1 + n_fft // 2]."""
    edges = mel_to_hz(np.linspace(0.0, hz_to_mel(sr / 2.0), n_mels + 2))
    freqs = np.arange(1 + n_fft // 2, dtype=np.float64) * sr / n_fft
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rise = (freqs[None] - lo) / (mid - lo)
    fall = (hi - freqs[None]) / (hi - mid)
    return np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))


def target_magnitude(mel, hp) -> np.ndarray:
    """[T, n_mels] normalised mel -> the [T, 1 + n_fft // 2] magnitude (to
    ``hp.power``) that Griffin-Lim is asked for."""
    m = np.asarray(mel, np.float64)
    if hp.symmetric_mel:
        m = (m + hp.max_abs_value) / (2.0 * hp.max_abs_value)
    db = np.clip(m, 0.0, 1.0) * hp.max_db - hp.max_db + hp.ref_db
    amp = 10.0 ** (db / 20.0)
    basis = mel_filterbank(hp.sr, hp.n_fft, hp.num_mels)
    return np.maximum(amp @ np.linalg.pinv(basis).T, 1e-10) ** hp.power


class Stft:
    """float64 STFT and overlap-add inverse of one signal length's frames."""

    def __init__(self, hp, device):
        self.n_fft, self.hop = hp.n_fft, hp.hop_length
        n = np.arange(hp.win_length)
        hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / hp.win_length)
        left = (hp.n_fft - hp.win_length) // 2
        win = np.zeros(hp.n_fft)
        win[left:left + hp.win_length] = hann
        self.window = torch.tensor(win, dtype=torch.float64, device=device)
        self.device = device

    def forward(self, y):
        """[L] -> [1 + L // hop, 1 + n_fft // 2] complex128."""
        half = self.n_fft // 2
        pad = torch.nn.functional.pad(y[None, None], (half, half),
                                      mode="reflect")[0, 0]
        return torch.fft.rfft(pad.unfold(0, self.n_fft, self.hop) *
                              self.window, dim=-1)

    def inverse(self, spec):
        """[T, 1 + n_fft // 2] -> [(T - 1) hop] float64."""
        t = spec.shape[0]
        frames = torch.fft.irfft(spec, n=self.n_fft, dim=-1) * self.window
        index = (torch.arange(t, device=self.device)[:, None] * self.hop +
                 torch.arange(self.n_fft, device=self.device)[None]
                 ).reshape(-1)
        out_len = self.n_fft + self.hop * (t - 1)
        y = torch.zeros(out_len, dtype=torch.float64, device=self.device)
        y.index_add_(0, index, frames.reshape(-1))
        wsq = torch.zeros_like(y).index_add_(
            0, index, (self.window ** 2).repeat(t))
        y = torch.where(wsq > 1e-300, y / wsq.clamp(min=1e-300), y)
        half = self.n_fft // 2
        return y[half:out_len - half]


def griffin_lim(mag, hp, device, n_iter=None, round_to=None):
    """The float64 Griffin-Lim of a [T, F] magnitude from zero phase,
    before de-emphasis: [(T - 1) hop] float64 on ``device``."""
    rnd = (lambda t: t) if round_to is None else \
        (lambda t: t.to(round_to).to(torch.float64))
    crnd = (lambda z: z) if round_to is None else \
        (lambda z: torch.complex(rnd(z.real), rnd(z.imag)))
    s = Stft(hp, device)
    m = rnd(torch.as_tensor(mag, dtype=torch.float64, device=device))
    x = m.to(torch.complex128)
    for _ in range(hp.n_iter if n_iter is None else n_iter):
        est = crnd(s.forward(rnd(s.inverse(x))))
        x = crnd(m * (est / est.abs().clamp(min=1e-8)))
    return rnd(s.inverse(x))


def undo_deemphasis(wav, coef):
    """The FIR that the de-emphasis IIR inverts: y[0], y[n] - c y[n - 1]."""
    y = np.asarray(wav, np.float64)
    return np.concatenate([y[:1], y[1:] - coef * y[:-1]])


def spectral_convergence(signal, mag, hp, device) -> float:
    """|| |STFT(signal)| - mag || / || mag || over the frames they share;
    ``signal`` is before de-emphasis."""
    y = torch.as_tensor(np.asarray(signal, np.float64), device=device)
    got = Stft(hp, device).forward(y).abs()
    want = torch.as_tensor(mag, dtype=torch.float64, device=device)
    t = min(got.shape[0], want.shape[0])
    return float((got[:t] - want[:t]).norm() / want[:t].norm())


def judge_wave(wav, mel, n_vocoded, hp, device, variants=()):
    """The numbers of one waveform that the program made from ``mel``
    [T, n_mels] trimmed to ``n_vocoded`` - 1 frames: (numbers, the
    variants' numbers).  ``variants`` names stand-ins put in the program's
    place: "bf16" (the control: the float64 Griffin-Lim rounded to bf16),
    "no_deemphasis", "unchanged" (no iteration: the zero phase kept) and
    "quarter_lost" (the last quarter of the waveform zeroed)."""
    t = mel.shape[0]
    keep = max(0, min(int(n_vocoded), t) - 1) * hp.hop_length
    mag = target_magnitude(mel, hp)
    ref = griffin_lim(mag, hp, device)[:keep].cpu().numpy()
    floor = spectral_convergence(ref, mag, hp, device) if keep else 0.0

    def numbers(w, before_deemphasis=False):
        w = np.asarray(w, np.float64)
        if len(w) != keep:
            return {"wave_len_faults": 1, "wave_sc_gap": float("inf")}
        sig = w if before_deemphasis else undo_deemphasis(w, hp.preemphasis)
        return {"wave_len_faults": 0,
                "wave_sc_gap": spectral_convergence(sig, mag, hp, device) -
                floor if keep else 0.0}
    out = numbers(wav)
    extra = {}
    for v in variants:
        if v == "bf16":
            w = griffin_lim(mag, hp, device, round_to=torch.bfloat16)
            extra[v] = numbers(w[:keep].cpu().numpy(), True)
        elif v == "unchanged":
            w = griffin_lim(mag, hp, device, n_iter=0)
            extra[v] = numbers(w[:keep].cpu().numpy(), True)
        elif v == "no_deemphasis":
            # the program's signal read as if it had not been de-emphasised
            extra[v] = numbers(undo_deemphasis(wav, hp.preemphasis))
        elif v == "quarter_lost":
            w = np.array(ref)
            w[3 * len(w) // 4:] = 0.0
            extra[v] = numbers(w, True)
        else:
            raise KeyError(v)
    return out, extra
