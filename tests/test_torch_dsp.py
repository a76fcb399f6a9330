"""The port's batched DSP (``ops/dsp_torch.py``), its numpy copy
(``ops/dsp.py``) and the plain version of the ``fused_frame_mel`` kernel
(``ops/mel.py``) against the JAX package, on the CPU at
``default_config()`` with the same numpy inputs.

Tolerances, each set from the reading it states (this CPU, float32):
- pre-emphasis and framing: exact (one rounding per sample in both);
- de-emphasis: 2e-5 of the output's largest magnitude against the JAX
  associative scan and numpy's float64 ``lfilter`` (read 3.9e-7 and
  2.5e-7: the scans sum in other orders);
- STFT / inverse STFT: 1e-5 of the largest magnitude (read 1.6e-7 and
  2.6e-7: pocketfft in both, other overlap-add orders), and the round trip
  within 1e-5 of the signal (read 1.8e-7);
- ``melspectrogram(use_pallas=False)``: 1e-4 against JAX (read 4.8e-5 on
  the [-4, 4] scale) and 2e-3 against numpy (read 4.6e-5), the bar
  ``tests/test_dsp.py`` sets for the JAX route;
- ``mel2wav`` of mels taken from tones: 1e-4 of the largest sample with no
  Griffin-Lim iteration (read 8.0e-6), 1e-2 at n_iter=2, also for
  ``vocode_batch`` (read 1.8e-3).  Griffin-Lim amplifies float noise
  through the phase of quiet bins: the JAX function itself moves by 1.7e-3
  of its largest sample when its input mel moves by one ulp;
- ``fused_frame_mel_plain`` against the JAX kernel in interpret mode:
  max 1e-2 and mean 1e-5 on the normalised mel (read 5.2e-4 / 1.2e-3 and
  8.9e-7 / 2.2e-6 for the two inputs: the fp32 DFT sums in another order,
  so a magnitude now and then rounds to the neighbouring bf16 value; a
  plain version that leaves the magnitude unrounded reads mean 2.8e-4 on
  both and fails), and
  the numpy bar of ``tests/test_mel_pallas.py`` (max 0.05, mean 0.01;
  read 2.3e-3 and 4.1e-4);
- the CUDA kernel's tables: its FFT twiddles within half an fp32 ulp of
  numpy's float64 values (one rounding), its sparse mel bands rebuilding
  ``dft_mel_mats``' bf16 weights exactly, and its FFT's data flow (the
  32 x 32 four-step FFT, bit-reversed registers, the real-FFT split step),
  replayed in float64 with those twiddles, within 1e-6 of numpy's rfft
  (relative to the largest magnitude; read 7.5e-8: the twiddles' fp32
  rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import default_config as jax_cfg
from few_shot_transformer_tts_tpu.infer.synthesize import \
    vocode_batch as jax_vocode_batch
from few_shot_transformer_tts_tpu.ops import dsp as jax_dsp
from few_shot_transformer_tts_tpu.ops import dsp_jax
from few_shot_transformer_tts_tpu.ops.mel_pallas import \
    fused_frame_mel as jax_fused_frame_mel
from few_shot_transformer_tts_torch.config import default_config
from few_shot_transformer_tts_torch.infer import vocode_batch
from few_shot_transformer_tts_torch.ops import cuda_build, dsp, dsp_torch, mel

HP = default_config()
JHP = jax_cfg()


def make_wavs(b, n, seed=0):
    """Two tones and noise per row, the amplitude varying by row."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    rows = [(0.5 * np.sin(2 * np.pi * (220 + 50 * i) * t) +
             0.2 * np.sin(2 * np.pi * 880 * t) + 0.01 * rng.randn(n)) /
            (1 + i) for i in range(b)]
    return np.stack(rows).astype(np.float32)


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def test_preemphasis_and_framing_match_jax():
    wav = make_wavs(2, 3000)
    pre = dsp_torch.preemphasis(torch.from_numpy(wav), HP.preemphasis)
    want = np.asarray(dsp_jax.preemphasis(jnp.asarray(wav), HP.preemphasis))
    np.testing.assert_array_equal(pre.numpy(), want)
    frames = dsp_torch.frame_signal(pre, HP.n_fft, HP.hop_length)
    want_frames = np.asarray(dsp_jax.frame_signal(jnp.asarray(want),
                                                  HP.n_fft, HP.hop_length))
    assert frames.shape == (2, 1 + 3000 // HP.hop_length, HP.n_fft)
    np.testing.assert_array_equal(frames.numpy(), want_frames)


def test_frame_signal_needs_more_than_half_a_window():
    with pytest.raises(ValueError, match="reflect padding"):
        dsp_torch.frame_signal(torch.zeros(1, HP.n_fft // 2), HP.n_fft,
                               HP.hop_length)


def test_deemphasis_matches_jax_and_lfilter():
    wav = make_wavs(2, 16000)
    got = dsp_torch.deemphasis(torch.from_numpy(wav), 0.97).numpy()
    want = np.asarray(jax.jit(dsp_jax.deemphasis, static_argnums=1)(
        jnp.asarray(wav), 0.97))
    assert rel(got, want) < 2e-5
    for i in range(2):
        assert rel(got[i], dsp.deemphasis(wav[i].astype(np.float64),
                                          0.97)) < 2e-5
    # the inverse of pre-emphasis
    back = dsp_torch.deemphasis(dsp_torch.preemphasis(
        torch.from_numpy(wav), 0.97), 0.97).numpy()
    assert rel(back, wav) < 2e-5


def test_stft_and_istft_match_jax():
    wav = make_wavs(2, 16000)
    spec = dsp_torch.stft(torch.from_numpy(wav), HP)
    want = np.asarray(dsp_jax.stft(jnp.asarray(wav), JHP))
    assert spec.shape == want.shape == (2, 81, 1 + HP.n_fft // 2)
    assert rel(spec.numpy(), want) < 1e-5
    np.testing.assert_allclose(dsp_torch.stft_mag(torch.from_numpy(wav),
                                                  HP).numpy(),
                               np.abs(spec.numpy()), rtol=1e-6, atol=0)
    rec = dsp_torch.istft(spec, HP).numpy()
    want_rec = np.asarray(dsp_jax.istft(jnp.asarray(want), JHP))
    assert rec.shape == want_rec.shape == wav.shape
    assert rel(rec, want_rec) < 1e-5
    np.testing.assert_allclose(rec, wav, rtol=0, atol=1e-5)


def test_numpy_copy_matches_the_jax_package():
    wav = make_wavs(1, 8000)[0]
    np.testing.assert_array_equal(dsp.get_spectrograms(wav, HP),
                                  jax_dsp.get_spectrograms(wav, JHP))
    db = np.linspace(-120, 40, 50)
    np.testing.assert_array_equal(dsp.normalize_mel_db(db, HP),
                                  jax_dsp.normalize_mel_db(db, JHP))


def test_melspectrogram_matches_jax_and_numpy():
    wav = make_wavs(2, 16000)
    got = dsp_torch.melspectrogram(torch.from_numpy(wav), HP).numpy()
    want = np.asarray(dsp_jax.melspectrogram(jnp.asarray(wav), JHP))
    assert got.shape == want.shape == (2, 81, HP.num_mels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for i in range(2):
        np.testing.assert_allclose(got[i], dsp.get_spectrograms(wav[i], HP),
                                   rtol=0, atol=2e-3)


@pytest.mark.parametrize("n_iter", [0, 2])
def test_mel2wav_matches_jax(n_iter):
    hp, jhp = HP.replace(n_iter=n_iter), JHP.replace(n_iter=n_iter)
    mels = np.stack([dsp.get_spectrograms(w, hp)
                     for w in make_wavs(2, 8000)])             # [2, 41, 80]
    got = dsp_torch.mel2wav(torch.from_numpy(mels), hp).numpy()
    want = np.asarray(dsp_jax.mel2wav(jnp.asarray(mels), jhp))
    assert got.shape == want.shape == (2, 40 * hp.hop_length)
    assert rel(got, want) < (1e-4 if n_iter == 0 else 1e-2)


def test_vocode_batch_matches_jax_and_numpy():
    hp, jhp = HP.replace(n_iter=2), JHP.replace(n_iter=2)
    mels = np.stack([dsp.get_spectrograms(w, hp)
                     for w in make_wavs(2, 8000)])
    lengths = [41, 25]
    wavs = vocode_batch(mels, lengths, hp, device="cpu")
    want = jax_vocode_batch(mels, lengths, jhp)
    assert [len(w) for w in wavs] == [len(w) for w in want] == \
        [40 * hp.hop_length, 24 * hp.hop_length]
    for w, ww in zip(wavs, want):
        assert w.dtype == np.float32 and rel(w, ww) < 1e-2
    # against the per-sample numpy path by envelope, as
    # tests/test_synthesize.py holds the JAX package's vocode_batch
    ref = dsp.mel2wav(mels[0], hp)
    n = min(len(ref), len(wavs[0]))
    env = lambda x: np.sqrt(np.convolve(x[:n] ** 2, np.ones(400) / 400,
                                        "valid"))
    assert np.corrcoef(env(wavs[0]), env(ref))[0, 1] > 0.9


@pytest.mark.parametrize("shape", [(1, 16000), (2, 6400)],
                         ids=["one_second", "batched"])
def test_fused_frame_mel_plain_matches_the_interpret_kernel(shape):
    pre = np.stack([dsp.preemphasis(w.astype(np.float64), HP.preemphasis)
                    for w in make_wavs(*shape)]).astype(np.float32)
    y = torch.from_numpy(pre)
    got = mel.fused_frame_mel_plain(mel.windowed_frames(y, HP), HP).numpy()
    want = np.asarray(jax_fused_frame_mel(jnp.asarray(pre), JHP,
                                          interpret=True))
    assert got.shape == want.shape == (shape[0], 1 + shape[1] //
                                       HP.hop_length, HP.num_mels)
    err = np.abs(got - want)
    assert err.max() < 1e-2 and err.mean() < 1e-5, (err.max(), err.mean())
    # the wrapper's CPU route is the plain version
    np.testing.assert_array_equal(mel.fused_frame_mel(y, HP).numpy(), got)


def test_fused_route_matches_numpy():
    wav = make_wavs(1, 16000)[0]
    got = dsp_torch.melspectrogram(torch.from_numpy(wav)[None], HP,
                                   use_pallas=True)[0].numpy()
    want = dsp.get_spectrograms(wav, HP)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() < 0.05 and err.mean() < 0.01


def test_dft_mel_mats_match_the_tpu_kernel_tables():
    from few_shot_transformer_tts_tpu.ops.mel_pallas import _dft_mel_mats
    cos, sin, mel_w = mel.dft_mel_mats(HP)
    n_freqs = 1 + HP.n_fft // 2
    jcos, jsin, jmel = _dft_mel_mats(HP.sr, HP.n_fft, HP.num_mels, 256)
    assert cos.shape == (HP.n_fft, 1088) and mel_w.shape == (1088, 80)
    np.testing.assert_array_equal(cos[:, :n_freqs], jcos[:, :n_freqs])
    np.testing.assert_array_equal(sin[:, :n_freqs], jsin[:, :n_freqs])
    np.testing.assert_array_equal(mel_w[:n_freqs], jmel[:n_freqs, :80])
    assert not cos[:, n_freqs:].any() and not mel_w[n_freqs:].any()


def _exp_table(n_fft):
    """numpy's float64 W values in the order of mel.fft_twiddles."""
    m, j = n_fft // 2, np.arange(32)
    return np.concatenate([np.exp(-2j * np.pi * np.arange(16) / 32),
                           np.exp(-2j * np.pi * (np.outer(j, j) % m)
                                  .reshape(-1) / m),
                           np.exp(-2j * np.pi * np.arange(m) / n_fft)])


def test_fft_twiddles_are_rounded_once_from_float64():
    tw = mel.fft_twiddles(HP.n_fft)
    want = _exp_table(HP.n_fft)
    assert tw.shape == (16 + HP.n_fft, 2) and tw.dtype == np.float32
    for got, ref in ((tw[:, 0], want.real), (tw[:, 1], want.imag)):
        ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
        assert (np.abs(got - ref) <= 0.5 * ulp + 1e-15).all()
    with pytest.raises(ValueError, match="n_fft 2048"):
        mel.fft_twiddles(1024)


@pytest.mark.parametrize("hp", [HP, HP.replace(num_mels=20)],
                         ids=["80_mels", "20_mels"])
def test_mel_bands_rebuild_the_dense_bf16_weights(hp):
    band, weights = mel.mel_bands(hp)
    dense = torch.from_numpy(mel.dft_mel_mats(hp)[2]).to(torch.bfloat16)
    rebuilt = torch.zeros_like(dense)
    for m, (start, count, offset) in enumerate(band.T):
        rebuilt[start:start + count, m] = weights[offset:offset + count]
    assert torch.equal(rebuilt, dense)
    assert weights.dtype == torch.bfloat16 and band.dtype == np.int32
    assert int(band[1].sum()) == weights.numel() == int(
        torch.count_nonzero(dense))
    if hp.num_mels == 80:
        assert weights.numel() == 2004


def _dif32(a, tw32):
    """The kernel's 32-point radix-2 decimation-in-frequency FFT over axis
    0; row i of the result is bin bitrev5(i)."""
    a = a.copy()
    span = 16
    while span:
        for g0 in range(0, 32, 2 * span):
            for j in range(span):
                u, v = a[g0 + j].copy(), a[g0 + j + span].copy()
                a[g0 + j] = u + v
                a[g0 + j + span] = (u - v) * (
                    tw32[j * (32 // (2 * span))] if j else 1.0)
        span //= 2
    return a


def _kernel_spectrum(x, tw):
    """csrc/frame_mel.cu's FFT of one 2048-sample frame, replayed in
    float64: lanes are columns, registers rows."""
    w = tw[:, 0].astype(np.float64) + 1j * tw[:, 1]
    tw32, mid, split = w[:16], w[16:16 + 1024], w[16 + 1024:]
    rev = np.array([int("{:05b}".format(i)[::-1], 2) for i in range(32)])
    lane = np.arange(32)
    z = (x[0::2] + 1j * x[1::2]).reshape(32, 32)        # [n1, lane]
    a = _dif32(z, tw32)                                  # [i, lane]
    ex = np.empty((32, 32), complex)
    ex[rev] = a * mid[rev[:, None] * 32 + lane[None, :]]  # [k1, n2]
    b = _dif32(ex.T, tw32)                               # [i, k1]
    zs = np.empty(1024, complex)
    zs[lane[None, :] + 32 * rev[:, None]] = b
    f = np.arange(1024)
    zf, zc = zs, zs[(1024 - f) & 1023]
    er, ei = 0.5 * (zf.real + zc.real), 0.5 * (zf.imag - zc.imag)
    orr, oi = 0.5 * (zf.imag + zc.imag), 0.5 * (zc.real - zf.real)
    ws = split[f]
    spec = (er + (ws.real * orr - ws.imag * oi)) + \
        1j * (ei + (ws.real * oi + ws.imag * orr))
    return np.append(spec, zs[0].real - zs[0].imag)


def test_kernel_fft_data_flow_matches_rfft():
    pre = dsp.preemphasis(make_wavs(1, 16000)[0].astype(np.float64),
                          HP.preemphasis)
    frames = mel.windowed_frames(torch.from_numpy(pre.astype(np.float32)),
                                 HP).numpy().astype(np.float64)
    tw = mel.fft_twiddles(HP.n_fft)
    for t in (0, 40, frames.shape[0] - 1):
        got = _kernel_spectrum(frames[t], tw)
        want = np.fft.rfft(frames[t])
        assert got.shape == want.shape == (1 + HP.n_fft // 2,)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_cpu_route_never_builds_and_other_devices_raise(monkeypatch):
    def no_build(name):
        raise AssertionError("the CPU route reached cuda_build")
    monkeypatch.setattr(cuda_build, "load", no_build)
    mel._library.cache_clear()
    y = torch.from_numpy(make_wavs(1, 3000))
    before = mel.fused_frame_mel.launches
    assert mel.fused_frame_mel(y, HP).shape == (1, 16, HP.num_mels)
    assert mel.fused_frame_mel.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mel.fused_frame_mel(y.to("meta"), HP)
