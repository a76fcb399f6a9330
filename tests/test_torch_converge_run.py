"""The port's convergence run (``few_shot_transformer_tts_torch/
converge_run.py``):

- ``LEARNABLE_HPARAMS`` is ``converge_r05/hparams_cli.txt`` (the JAX
  package's convergence record) without its width keys;
- ``step_seconds`` splits the logged steps by whether their log burst
  overlapped an eval interval, and ``step_lines`` reads nan losses;
- a tiny run end to end on the CPU: 2 segments of 3 steps with a watcher
  each (every checkpoint scored), an adaptation phase of 3 steps between
  two one-shot passes on all three languages, and both reports, with the
  record's files.
"""

import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest

from few_shot_transformer_tts_torch import converge_run
from few_shot_transformer_tts_torch.config import default_config

ROOT = Path(__file__).resolve().parents[1]
WIDTH_KEYS = ("embed_size", "encoder_hidden", "decoder_hidden",
              "n_encoder_layer", "n_decoder_layer", "n_attention_head",
              "prenet_hidden", "postnet_hidden", "n_postnet_layer",
              "speaker_embedding_size", "language_embedding_size",
              "language_net_hidden")


def test_learnable_hparams_are_the_records_without_its_widths():
    spec = (ROOT / "converge_r05" / "hparams_cli.txt").read_text().strip()
    pairs = [kv.split("=") for kv in spec.split(",")]
    assert [k for k, _ in pairs[:len(WIDTH_KEYS)]] == list(WIDTH_KEYS)
    rest = ",".join("=".join(kv) for kv in pairs[len(WIDTH_KEYS):])
    assert converge_run.LEARNABLE_HPARAMS == rest
    hp = default_config().parse(converge_run.LEARNABLE_HPARAMS)
    assert (hp.max_lr, hp.warmup_steps, hp.batch_frame_limit,
            hp.max_generation_frames) == (0.0007, 1500, 6000, 192)
    # the widths stay the flagship's
    assert (hp.encoder_hidden, hp.decoder_hidden, hp.n_attention_head,
            hp.n_encoder_layer) == (512, 768, 8, 6)


def test_step_seconds_splits_by_the_watcher_and_reads_nan(tmp_path):
    lines = []
    for step in range(1, 9):
        # bursts of 2 steps at t = 10, 12, 14, 16 s
        t = 10 + 2 * ((step - 1) // 2)
        loss = "nan" if step == 5 else "0.50000"
        lines.append("[INFO 2026-01-01 00:00:%02d,000] [Step %d] %.3f "
                     "sec/step (1.0), lr=0.000700, loss=%s, mse_loss=%s "
                     "(Ave. 0.5), 10.0 audio_s/s" % (t, step, step / 10.0,
                                                      loss, loss))
    (tmp_path / "outputs_1.log").write_text("\n".join(lines) + "\n")
    rows = converge_run.step_lines(str(tmp_path))
    assert [r[1] for r in rows] == list(range(1, 9))
    assert np.isnan(rows[4][3]) and rows[0][3] == 0.5
    t0 = rows[0][0]
    # the watcher scored from 12.5 s to 13.5 s: inside the burst 12-14 s
    busy = [(t0 + 2.5, t0 + 3.5, 1.0, 1000)]
    got = converge_run.step_seconds(rows, busy)
    assert got["steps"] == 8 and got["steps_watcher_scoring"] == 2
    assert got["median_watcher_scoring"] == pytest.approx(0.55)
    assert got["median_watcher_idle"] == pytest.approx(np.median(
        [0.1, 0.2, 0.3, 0.4, 0.7, 0.8]))
    assert converge_run.step_seconds(rows, (), 3, 4)["steps"] == 2
    assert converge_run.window_mse(rows, 1, 4) == 0.5


@pytest.fixture(autouse=True)
def _keep_root_logger(monkeypatch):
    """The report's decode logs through the root logger; restore it."""
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)


TINY = ("embed_size=32,encoder_hidden=32,decoder_hidden=48,"
        "n_encoder_layer=2,n_decoder_layer=2,n_attention_head=4,"
        "prenet_hidden=16,postnet_hidden=24,n_postnet_layer=3,"
        "speaker_embedding_size=8,language_embedding_size=8,"
        "language_net_hidden=8,use_bfloat16=False,bucket_size=32,"
        "batch_frame_limit=1200,batch_frame_quad_limit=200000,"
        "max_generation_frames=16,max_eval_batches=1,n_iter=2")


def test_tiny_run_end_to_end(tmp_path, monkeypatch):
    # the run's seven processes go without matplotlib (the plots are
    # optional) and TensorFlow (which TensorBoard, the CLIs' scalar writer,
    # loads where it is installed, seconds a process)
    (tmp_path / "shim").mkdir()
    for name in ("tensorflow", "matplotlib"):
        (tmp_path / "shim" / (name + ".py")).write_text(
            "raise ImportError('%s is kept out of this run')\n" % name)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path / "shim"), os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / "out"
    record = converge_run.main([
        "--work", str(tmp_path / "work"), "--out-dir", str(out),
        "--steps", "6", "--checkpoint-interval", "3", "--segments", "2",
        "--adapt-steps", "3", "--adapt-ramp", "2", "--scan-interval", "1",
        "--summary-interval", "1",
        "--hparams", TINY, "--corpus-args",
        "--n_train 16 --n_adapt 4 --n_eval 2",
        "--device", "cpu"])
    assert [(s["first_step"], s["last_step"]) for s in record["segments"]] \
        == [(1, 3), (4, 6)]
    # each segment's watcher scored its checkpoint
    phase1 = [json.loads(line) for line in
              (out / "eval_metrics_phase1.jsonl").read_text().splitlines()]
    assert sorted({(m["step"], m["tag"]) for m in phase1
                   if m["tag"].startswith("mse_dtw/")}) == \
        [(s, "mse_dtw/" + lang) for s in (3, 6)
         for lang in ("de-de", "en-us")]
    assert record["phase1"]["all_losses_finite"]
    assert record["phase1"]["logged_steps"] == 6
    assert [s for s, _ in record["phase1"]["eval_s_per_checkpoint"]] == \
        [3, 6]
    assert record["adapt"]["logged_steps"] == 3
    assert record["tmp_files_left"] == []
    for name, step in (("pre", 6), ("post", 9)):
        tags = {(m["step"], m["tag"]) for m in map(json.loads, (
            out / ("eval_metrics_%sadapt.jsonl" % name)).read_text()
            .splitlines())}
        assert {(step, "mse_dtw/fr-fr"), (step, "mse_dtw/en-us"),
                (step, "mse_dtw/de-de")} <= tags
    counts = [json.loads(line) for line in
              (out / "adapt_counts.jsonl").read_text().splitlines()]
    assert {m["step"] for m in counts} == {7, 8, 9}
    assert all(m["tag"].startswith("counts/") for m in counts)
    sampled = (out / "train_steps_sampled.log").read_text().splitlines()
    assert len(sampled) == 1 and "[Step 1]" in sampled[0]
    summary = json.loads((out / "summary.json").read_text())
    assert summary["checkpoint"].endswith("model.ckpt-6")
    assert sorted(summary["adapt_ramp_fr_share"], key=int) == ["7", "8",
                                                               "9"]
    adapt = json.loads((out / "adapt" / "summary.json").read_text())
    assert adapt["checkpoint"].endswith("model.ckpt-9")
    assert json.loads((out / "run.json").read_text()) == record
    # the bars of CONVERGE_torch.md, computed again from the record alone
    assert set(record["bars"]) == {
        "last_100_mse_window", "decode_eager_at_floor",
        "decode_fused_at_floor", "alignment_eager", "alignment_fused",
        "watcher_scored_every_checkpoint", "fr_share", "fr_mse_dtw",
        "base_languages_after_adaptation"}
    assert record["bars"]["watcher_scored_every_checkpoint"]["met"]
    assert not record["bars"]["last_100_mse_window"]["met"]  # 6 steps
    assert converge_run.main(["--bars", str(out)]) == record["bars"]
    assert not os.path.exists(out / "model.ckpt-6")
