"""AR synthesis of the port: frame-for-frame parity with the JAX package's
``synthesize_batch`` (fp32, mel atol 1e-4, generated lengths exactly equal),
and the output contract, stop latch, padding invariance and dropout mode
that the JAX package's own synthesis tests check."""

import logging
import os
import sys

import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.infer import \
    synthesize_batch as jax_synthesize_batch
from few_shot_transformer_tts_tpu.models import ByteToMel as JaxByteToMel
from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.infer import (save_eval_results,
                                                  synthesize_batch)

from test_torch_weights import jax_variables, port_model

HP = small_test_config()


def input_batch(b=4, t_in=10, seed=3):
    rng = np.random.RandomState(seed)
    return dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=np.asarray([10, 7, 9, 5][:b], np.int32),
        input_spk_ids=np.arange(b, dtype=np.int32),
        input_language_vecs=np.eye(HP.max_num_language,
                                   dtype=np.float32)[:b],
        names=["s%d" % i for i in range(b)],
    )


def with_stop_head(variables, seed, scale=50.0, bias=-60.0):
    """Stop head with large random weights, so stop logits sit far from 0
    and the two packages cannot disagree on a sign."""
    w = variables["params"]["decoder"]["stop_net"]
    w["kernel"] = (scale * np.random.RandomState(seed).randn(
        *w["kernel"].shape) / np.sqrt(w["kernel"].shape[0])).astype(
            np.float32)
    w["bias"] = np.asarray([bias], np.float32)
    return variables


@pytest.fixture(scope="module")
def model():
    """Every row runs to the frame cap (stop logits near -1e4)."""
    return port_model(with_stop_head(jax_variables(7), 0, bias=-1e4))


# kernel seed -> generated lengths: 0 runs every row to the cap, 7 stops
# rows at different frames while one runs to the cap, 3 stops every row
# early so the loop exits before the cap
@pytest.mark.parametrize("stop_seed,expect", [
    (0, [31, 31, 31, 31]), (7, [8, 31, 2, 25]), (3, [1, 2, 1, 4])],
    ids=["to_cap", "mixed_stops", "all_stop_early"])
def test_deterministic_decode_matches_jax(stop_seed, expect):
    variables = with_stop_head(jax_variables(7), stop_seed)
    batch = input_batch()
    want = jax_synthesize_batch(JaxByteToMel(jax_cfg()), variables, batch,
                                jax_cfg(), deterministic=True, max_frames=30)
    got = synthesize_batch(port_model(variables), batch, HP,
                           deterministic=True, max_frames=30)
    assert [int(x) for x in got["generated_lengths"]] == expect
    assert got["generated_lengths"] == want["generated_lengths"]
    assert got["mel_pre"].shape == want["mel_pre"].shape
    np.testing.assert_allclose(got["mel_pre"], want["mel_pre"], atol=1e-4)
    np.testing.assert_allclose(got["mel_aft"], want["mel_aft"], atol=1e-4)
    for w, g in zip(want["alignments"]["encdec"],
                    got["alignments"]["encdec"]):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_synthesis_output_contract(model):
    out = synthesize_batch(model, input_batch(b=2), HP, deterministic=True,
                           max_frames=20)
    n = out["mel_pre"].shape[1]
    assert out["mel_pre"].shape == (2, n, HP.num_mels)
    assert out["mel_aft"].shape == (2, n, HP.num_mels)
    assert out["mel_pre"].dtype == np.float32
    assert len(out["generated_lengths"]) == 2
    assert out["names"] == ["s0", "s1"]
    assert np.all(np.isfinite(out["mel_pre"]))
    enc_aligns = out["alignments"]["encdec"]
    assert len(enc_aligns) == HP.n_decoder_layer
    assert enc_aligns[0].shape == (2, HP.n_attention_head, 10, n)
    assert enc_aligns[0][0, 0, :, 0].sum() == pytest.approx(1.0, abs=1e-3)
    # row 1 has 7 valid input bytes: no weight on the padded memory
    assert np.all(enc_aligns[0][1, :, 7:, :] < 1e-6)


def test_incremental_decode_matches_teacher_forced(model):
    """The generated mels reproduce themselves under the teacher-forced
    decoder: the KV-cache path agrees with the full-sequence path."""
    batch = input_batch(b=2)
    out = synthesize_batch(model, batch, HP, deterministic=True,
                           max_frames=16)
    gen = out["mel_pre"]
    lengths = np.minimum(np.asarray(out["generated_lengths"]), gen.shape[1])
    with torch.no_grad():
        tf = model(torch.from_numpy(batch["inputs"]),
                   torch.from_numpy(batch["input_lengths"]),
                   torch.from_numpy(gen),
                   torch.from_numpy(lengths.astype(np.int32)),
                   torch.from_numpy(batch["input_spk_ids"]),
                   torch.from_numpy(batch["input_language_vecs"]))
    for b in range(gen.shape[0]):
        np.testing.assert_allclose(tf["mel_bef"][b, :lengths[b]].numpy(),
                                   gen[b, :lengths[b]], atol=2e-4)


def test_stop_latches_and_lengths_freeze():
    variables = jax_variables(7)
    variables["params"]["decoder"]["stop_net"]["bias"] = \
        np.asarray([100.0], np.float32)
    out = synthesize_batch(port_model(variables), input_batch(b=2), HP,
                           deterministic=True, max_frames=16)
    assert all(l == 1 for l in out["generated_lengths"])
    assert out["mel_pre"].shape[1] == 1


def test_batch_padding_does_not_change_results(model):
    b1 = input_batch(b=2)
    out1 = synthesize_batch(model, b1, HP, deterministic=True, max_frames=12)
    b2 = {k: v[:1] for k, v in b1.items()}
    out2 = synthesize_batch(model, b2, HP, deterministic=True, max_frames=12)
    l0 = min(out1["mel_pre"].shape[1], out2["mel_pre"].shape[1])
    np.testing.assert_allclose(out1["mel_pre"][0, :l0],
                               out2["mel_pre"][0, :l0], atol=2e-4)


def test_dropout_decode_is_reproducible_under_one_seed(model):
    batch = input_batch(b=2)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return synthesize_batch(model, batch, HP, deterministic=False,
                                generator=gen, max_frames=8)["mel_pre"]

    a, b, c = run(1), run(2), run(1)
    np.testing.assert_array_equal(a, c)
    assert not np.allclose(a, b)
    det = synthesize_batch(model, batch, HP, deterministic=True,
                           max_frames=8)["mel_pre"]
    assert not np.allclose(a, det)


def test_save_eval_results(tmp_path, model, monkeypatch, caplog):
    hp = HP.replace(n_iter=2)
    out = synthesize_batch(model, input_batch(b=2), hp, deterministic=True,
                           max_frames=12)
    save_eval_results(**out, output_dir=str(tmp_path), hp=hp,
                      save_trimmed_wave=True)
    files = os.listdir(tmp_path)
    for name in ["s0.npy", "s0.wav", "s0_trim.wav", "s1.npy", "s1.wav",
                 "s0_mel.png", "s0_align.png"]:
        assert name in files, files
    np.testing.assert_array_equal(
        np.load(tmp_path / "s1.npy"),
        out["mel_aft"][1][:out["generated_lengths"][1]])

    # without matplotlib the plots are skipped with one warning and the
    # audio outputs are still written
    from few_shot_transformer_tts_torch.utils import infolog
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(infolog, "_warned", [])
    no_plots = tmp_path / "no_plots"
    no_plots.mkdir()
    with caplog.at_level(logging.WARNING):
        save_eval_results(**out, output_dir=str(no_plots), hp=hp)
    assert sorted(os.listdir(no_plots)) == ["s0.npy", "s0.wav", "s1.npy",
                                            "s1.wav"]
    assert sum("matplotlib" in r.message for r in caplog.records) == 1
