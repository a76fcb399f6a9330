"""The plain reference against the program at small_test_config sizes on
the CPU (float32), with the benchmark's weights handed to both."""

import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.infer.synthesize import synthesize_batch
from few_shot_transformer_tts_torch.models.tacotron import (ByteToMel,
                                                             compute_loss)
from few_shot_transformer_tts_torch.ops import dsp, dsp_torch
from few_shot_transformer_tts_torch.ops.mha import dropout_keep_mask
from few_shot_transformer_tts_torch.train.loop import step_generator
from gpubench import traffic
from gpubench.reference import dropout, philox, vocoder
from gpubench.reference import model as M
from gpubench.reference.train import step_grads
from gpubench.weights import make_weights

CPU = torch.device("cpu")


def _pair(seed=3, stop_bias=0.0, **kw):
    hp = small_test_config(transformer_dropout_rate=0.1,
                           decoder_dropout_rate=0.5, **kw)
    ref_hp = M.hparams(hp.values())
    w = make_weights(ref_hp, seed, CPU, stop_bias)
    model = ByteToMel(hp, device="cpu")
    model.load_state_dict(w, strict=True)
    return hp, ref_hp, w, model


def _train_batch(hp, b=6, t_in=13, t_out=19, seed=0):
    rng = np.random.RandomState(seed)
    il = rng.randint(3, t_in + 1, b).astype(np.int32)
    tl = rng.randint(4, t_out + 1, b).astype(np.int32)
    il[-1] = tl[-1] = 0         # a lattice row
    mel = rng.uniform(-4, 4, (b, t_out, hp.num_mels)).astype(np.float32)
    mel[np.arange(t_out)[None] >= tl[:, None]] = 0
    lvec = np.eye(hp.max_num_language, dtype=np.float32)[
        rng.randint(0, hp.max_num_language, b)]
    return {k: torch.from_numpy(v) for k, v in dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=il, mel_targets=mel, target_lengths=tl,
        input_spk_ids=rng.randint(0, hp.max_num_speaker, b).astype(np.int32),
        input_language_vecs=lvec).items()}


@pytest.mark.parametrize("rows", [None, 2])
def test_training_step_matches_the_program(rows):
    hp, ref_hp, w, model = _pair()
    batch = _train_batch(hp)
    seed, step = 2 ** 31 + 5, 4
    model.train()
    out = model(batch["inputs"], batch["input_lengths"],
                batch["mel_targets"], batch["target_lengths"],
                batch["input_spk_ids"], batch["input_language_vecs"],
                train=True, generator=step_generator(seed, step, "cpu"))
    loss = compute_loss(model, batch["mel_targets"], batch["target_lengths"],
                        out, hp)["loss"]
    loss.backward()
    P = {n: t.clone().requires_grad_(M.is_parameter(n)) for n, t in w.items()}
    b, t_in = batch["inputs"].shape
    plan = dropout.DropPlan(ref_hp, b, t_in, batch["mel_targets"].shape[1],
                            dropout.generator(seed, step, CPU), CPU, "torch")
    got = step_grads(P, ref_hp, batch, plan, rows=rows)
    assert got["loss"] == pytest.approx(float(loss), rel=1e-6)
    for n, p in model.named_parameters():
        want = p.grad
        g = P[n].grad
        scale = max(float(want.abs().max()), 1e-12)
        assert float((g - want).abs().max()) / scale < 1e-4, n


def test_decoding_on_served_frames_matches_the_program():
    hp, ref_hp, w, model = _pair(stop_bias=-1e4, use_pallas_decode=True)
    mix = {"batch": 3, "input_bytes": [5, 12]}
    batch = traffic.synth_batches(mix, ref_hp, 11, 1)[0]
    out = synthesize_batch(model.eval(), batch, hp, deterministic=True,
                           collect_alignments=False, max_frames=16)
    for r in range(3):
        n = int(batch["input_lengths"][r])
        ids = torch.from_numpy(batch["inputs"][r:r + 1, :n])
        mem = M.encoder(w, ref_hp, ids, torch.tensor([n]),
                        torch.from_numpy(batch["input_spk_ids"][r:r + 1]),
                        torch.from_numpy(
                            batch["input_language_vecs"][r:r + 1]))
        frames = torch.from_numpy(out["mel_pre"][r])[None]
        mel, stop = M.decoder_on_frames(w, ref_hp, mem, frames)
        assert np.allclose(mel[0].numpy(), out["mel_pre"][r], atol=1e-4)
        assert bool((stop < 0).all())      # the stop bias of the weights
        res = M.postnet(w, ref_hp, frames, torch.tensor([16]))
        assert np.allclose(res[0].numpy(),
                           out["mel_aft"][r] - out["mel_pre"][r], atol=1e-4)


def test_philox_copy_is_the_kernels_mask():
    seed = torch.tensor([123456789012345], dtype=torch.int64)
    full = dropout_keep_mask(seed, 5, 3, 7, 9, 0.1)
    part = philox.keep_mask(seed, 2, 3, 3, 7, 9, 0.1)
    assert torch.equal(part, full[2:5])
    assert 0.8 < float(full.float().mean()) < 1.0


def test_vocoder_reference_judges_the_programs_griffin_lim():
    """The float64 reference is built apart from the program: its
    filterbank equals the program's, the program's waveform reads close to
    the float64 Griffin-Lim's spectral convergence, and the planted faults
    read far above it."""
    hp = small_test_config().replace(num_mels=80)
    assert np.allclose(vocoder.mel_filterbank(hp.sr, hp.n_fft, hp.num_mels),
                       dsp.get_mel_basis(hp), rtol=1e-9, atol=1e-12)
    rng = np.random.RandomState(0)
    mel = rng.uniform(-4, 2, (30, 80)).astype(np.float32)
    wav = dsp_torch.mel2wav(torch.from_numpy(mel)[None], hp)[0].numpy()
    keep = (len(mel) - 1) * hp.hop_length
    assert len(wav) == keep
    got, faults = vocoder.judge_wave(
        wav, mel, len(mel) + 1, hp, CPU,
        ("bf16", "unchanged", "no_deemphasis", "quarter_lost"))
    assert got["wave_len_faults"] == 0
    assert abs(got["wave_sc_gap"]) < 1e-3
    for name in ("unchanged", "no_deemphasis", "quarter_lost"):
        assert faults[name]["wave_sc_gap"] > 0.05, (name, faults)
    short, _ = vocoder.judge_wave(wav[:-1], mel, len(mel) + 1, hp, CPU)
    assert short["wave_len_faults"] == 1
