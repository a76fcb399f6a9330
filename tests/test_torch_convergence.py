"""The port's convergence report (``few_shot_transformer_tts_torch/
convergence.py``) against the JAX package's tool
(``tools/convergence_report.py``, loaded by path: it imports JAX only inside
its ``main``):

- ``parse_train_log``, ``parse_eval_metrics`` and ``diagonality`` give the
  tool's results, exactly, on inputs from a numpy seed: step lines among
  other log lines over two files, eval scalars out of order, a diagonal
  head with noise, a head parked on one position (the variance guard skips
  it) and a decode under 8 frames (no head qualifies);
- a tiny run on the CPU end to end: ``tools/make_learnable_corpus.py`` at a
  few rows, 6 steps of the train CLI, one ``--no_wait`` pass of the eval
  service, then ``convergence.py --device cpu``: ``summary.json`` holds the
  JAX summary's keys, and the eager and fused (plain) decodes agree in
  length on every sample.
"""

import importlib.util
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from few_shot_transformer_tts_torch import convergence
from few_shot_transformer_tts_torch import eval as eval_cli
from few_shot_transformer_tts_torch.train import cli as train_cli

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "convergence_report", ROOT / "tools" / "convergence_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def test_parse_train_log_matches_the_tool(tmp_path):
    rng = np.random.RandomState(0)
    for part in range(2):
        lines = []
        for step in rng.permutation(np.arange(1, 40) + 40 * part):
            loss, mse = rng.rand(2) * 3
            lines.append("[INFO 2026-01-01 00:00:00,000] [Step %d] 0.031 "
                         "sec/step (0.030), lr=0.000700, loss=%.5f, "
                         "mse_loss=%.5f (Ave. 1.0), 1520.3 audio_s/s"
                         % (step, loss, mse))
            lines.append("[INFO] Bucket of 128 examples -> 2 packed batches")
        (tmp_path / ("outputs_%d.log" % part)).write_text("\n".join(lines))
    (tmp_path / "other.log").write_text("[Step 999] loss=1.0, mse_loss=1.0")
    got = convergence.parse_train_log(str(tmp_path))
    assert got == TOOL.parse_train_log(str(tmp_path))
    assert [r[0] for r in got] == list(range(1, 40)) + list(range(41, 80))


def test_parse_eval_metrics_matches_the_tool(tmp_path):
    rng = np.random.RandomState(1)
    assert convergence.parse_eval_metrics(str(tmp_path)) == {}
    assert TOOL.parse_eval_metrics(str(tmp_path)) == {}
    lines = []
    for step in rng.permutation(np.arange(1, 7) * 500):
        for tag in ("mse_dtw/en-us", "mse_dtw/de-de", "cer/en-us",
                    "counts/en-us"):
            lines.append(json.dumps({"tag": tag, "value": float(rng.rand()),
                                     "step": int(step), "time": 0.0}))
    (tmp_path / "metrics.jsonl").write_text("\n".join(lines) + "\n")
    got = convergence.parse_eval_metrics(str(tmp_path))
    assert got == TOOL.parse_eval_metrics(str(tmp_path))
    assert sorted(got) == ["de-de", "en-us"] and len(got["en-us"]) == 6


def _alignments(rng, dec_len=60, enc_len=20, heads=4):
    """[H, T_dec, T_enc] weights: head 0 diagonal (4 frames a position)
    over noise, head 1 parked on one position, heads 2-3 noise."""
    a = rng.rand(heads, dec_len, enc_len).astype(np.float32) * 0.5
    for t in range(dec_len):
        a[0, t, min(enc_len - 1, t // 4)] += 1.0
        a[1, t, 5] += 1.0
    return a / a.sum(-1, keepdims=True)


@pytest.mark.parametrize("dec_len,enc_len", [(60, 20), (7, 20), (60, 12),
                                             (200, 64)])
def test_diagonality_matches_the_tool(dec_len, enc_len):
    rng = np.random.RandomState(dec_len + enc_len)
    a = _alignments(rng)
    got = convergence.diagonality(a, dec_len, enc_len)
    assert got == TOOL.diagonality(a, dec_len, enc_len)
    if dec_len < 8:
        assert got == {"r2": -1.0}          # too short: no head qualifies
    elif enc_len == 20:
        assert got["head"] == 0             # the parked head is skipped
        assert abs(got["slope"] - 0.25) < 0.02 and got["r2"] > 0.95
    # the parked head alone fits a constant: skipped, not R^2 = 1
    assert convergence.diagonality(a[1:2], dec_len, enc_len) == {"r2": -1.0}


# ---------------------------------------------------------------------------
# a tiny run end to end on the CPU
# ---------------------------------------------------------------------------

HP_SPEC = ("embed_size=32,encoder_hidden=32,decoder_hidden=48,"
           "n_encoder_layer=2,n_decoder_layer=2,n_attention_head=4,"
           "prenet_hidden=16,postnet_hidden=24,n_postnet_layer=3,"
           "speaker_embedding_size=8,language_embedding_size=8,"
           "language_net_hidden=8,use_bfloat16=False,bucket_size=32,"
           "data_warmup_steps=0,batch_frame_limit=1200,"
           "batch_frame_quad_limit=200000,max_generation_frames=24,"
           "max_eval_batches=1,n_iter=2,warmup_steps=1500,max_lr=0.0007")


@pytest.fixture(autouse=True)
def _keep_root_logger(monkeypatch):
    """The CLIs replace the root logger's handlers; restore them after."""
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)


def test_tiny_run_end_to_end(tmp_path):
    corpus, run = tmp_path / "corpus", tmp_path / "run"
    subprocess.run([sys.executable, str(ROOT / "tools" /
                                        "make_learnable_corpus.py"),
                    str(corpus), "--n_train", "24", "--n_adapt", "6",
                    "--n_eval", "2"], check=True, capture_output=True,
                   timeout=120)
    _, step = train_cli.main([
        "--model-dir", str(run / "models"), "--log-dir", str(run / "logs"),
        "--data-dir", str(corpus), "--training_languages", "en-us:de-de",
        "--max_steps", "6", "--checkpoint_interval", "3",
        "--log_interval", "2", "--summary_interval", "2", "--eval_steps",
        "99", "--hparams", HP_SPEC, "--device", "cpu"])
    assert step == 6
    assert sorted(os.listdir(run / "models")) == ["model.ckpt-3",
                                                  "model.ckpt-6"]
    records = eval_cli.main([
        "--model-dir", str(run / "models"),
        "--log-dir", str(run / "eval_logs"), "--data-dir", str(corpus),
        "--no_wait", "--start_step", "3", "--eval_interval", "3",
        "--eval_languages", "en-us:de-de", "--saver_pool", "thread",
        "--hparams", HP_SPEC, "--device", "cpu"])
    assert [r["step"] for r in records] == [3, 6]

    out = tmp_path / "report"
    summary = convergence.main([
        "--run-dir", str(run), "--corpus", str(corpus), "--out-dir",
        str(out), "--phase2-logdir", str(run / "logs"), "--device", "cpu"])
    assert json.loads((out / "summary.json").read_text()) == summary
    jax_keys = json.loads((ROOT / "converge_r05_flagship" /
                           "summary.json").read_text())
    assert set(jax_keys) <= set(summary)
    assert set(summary) - set(jax_keys) == {"fused_decode",
                                            "decode_agreement"}
    assert summary["checkpoint"].endswith("model.ckpt-6")
    assert summary["train_loss"]["steps"] == 6
    assert set(summary["train_loss"]) == set(jax_keys["train_loss"])
    assert sorted(summary["eval_mse_dtw"]) == ["de-de", "en-us"]
    for lang in summary["eval_mse_dtw"].values():
        assert set(lang) == {"first", "last", "n_ckpts",
                             "monotone_decreasing_pairs"}
        assert lang["n_ckpts"] == 2 and np.isfinite(lang["last"])
    # the eval batch: the 2 en-us and 2 de-de eval rows, in file order
    rows = summary["alignment_diagonality"]
    assert [r["name"] for r in rows] == \
        ["en0_0000010000", "en1_0000010001", "de0_0000010000",
         "de1_0000010001"]
    for r in rows:
        assert {"r2", "layer", "name", "dtw_mse", "generated_frames",
                "target_frames"} <= set(r) and np.isfinite(r["dtw_mse"])
    fused = summary["fused_decode"]["alignment_diagonality"]
    assert [r["generated_frames"] for r in fused] == \
        [r["generated_frames"] for r in rows]
    for a in summary["decode_agreement"]:
        assert a["eager_frames"] == a["fused_frames"]
        assert a["max_abs_mel_diff"] < 1e-3
    # no adaptation in this run: every sampled row is en-us or de-de
    assert sorted(summary["adapt_ramp_fr_share"], key=int) == ["2", "4", "6"]
    assert set(summary["adapt_ramp_fr_share"].values()) == {0.0}
