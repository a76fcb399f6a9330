"""A copy of the benchmark's layout at CPU-test size: the same drivers,
readers and reference, tiny widths and traffic."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from few_shot_transformer_tts_torch.config import small_test_config

HERE = Path(__file__).resolve().parents[1]

TINY_MIXES = {
    "train": {"kind": "train", "utterances": 96, "target_frames": [24, 60],
              "bytes_per_frame": 0.2, "bytes_jitter": 0.2,
              "mel_range": [-4.0, 4.0], "compared_steps": 3,
              "checked_window_step": [1, 2], "trace_after_steps": 1,
              "traced_steps": 2,
              "hparams": {"batch_frame_limit": 400,
                          "batch_frame_quad_limit": 400000,
                          "bucket_size": 32, "data_warmup_steps": 0}},
    "synth": {"kind": "batch_synth", "batch": 4, "input_bytes": [6, 20],
              "max_frames": 24, "hparams": {"use_pallas_decode": True},
              "stop_bias": -1e4,
              "batches": 4, "traced_calls": 1, "sample_rows": 3},
    "utt": {"kind": "utterance", "input_bytes": [6, 20],
            "frames_per_byte": 2, "frame_round": 8, "stratum_block": 4,
            "hparams": {"use_pallas_decode": True}, "requests": 8,
            "stop_bias": -1e4,
            "traced_requests": 2, "sample_requests": 2},
}


def tiny_config(**overrides) -> dict:
    hp = small_test_config(transformer_dropout_rate=0.1,
                           decoder_dropout_rate=0.5, **overrides)
    return hp.values()


def tiny_bench(tmp: Path, limits=None) -> Path:
    """A directory holding BENCHMARK.json, configs/, traffic/, limits/
    and metrics/ of a tiny benchmark with the real one's cells and
    metrics; returns it (both root and base of ``spec.load_cell``)."""
    tmp = Path(tmp)
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", tmp / "metrics")
    lj = tiny_config(multi_speaker=False, multi_lingual=False,
                     decoder_hidden=32)
    for c in real["configs"]:
        values = lj if c["name"] == "ljspeech" else tiny_config()
        (tmp / "configs" / (c["name"] + ".json")).write_text(json.dumps(
            {"name": c["name"], "hparams": values}))
        c["file"] = "configs/%s.json" % c["name"]
    for name, mix in TINY_MIXES.items():
        (tmp / "traffic" / (name + ".json")).write_text(json.dumps(mix))
    for w in real["workloads"]:
        lim = (limits or {}).get(w["name"])
        if lim is None:
            lim = json.loads((HERE / "limits" / (w["name"] + ".json"))
                             .read_text())
        (tmp / "limits" / (w["name"] + ".json")).write_text(json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(real))
    return tmp
