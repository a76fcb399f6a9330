"""The port's spans and counters (``utils/tracing.py``) on the CPU:

- a span's self time is its duration less its children's on its thread;
- a new window starts at each profiler start and stop, also for a thread
  that opened no span while the profiler ran;
- without a profiler no ``record_function`` runs; under one, every span is
  a ``user_annotation`` range of the Chrome trace, nested as the spans are;
- ``train_step`` gives ``train.step`` holding its four parts, and
  ``device_batch`` gives ``data.h2d``;
- ``synthesize_batch`` on both frame loops gives one ``synth.frame`` per
  frame step and a stop check every 16 frames;
- the train CLI's summary writes each span's host ms a step since the last;
- the Feeder counts the frames and padding of the batches it hands out;
- ``idle_gaps`` and ``busy_share`` on a hand-made trace.
"""

import io
import json
import threading
import time
import zipfile
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from few_shot_transformer_tts_torch.config import (default_config,
                                                   small_test_config)
from few_shot_transformer_tts_torch.data import Feeder
from few_shot_transformer_tts_torch.infer.synthesize import synthesize_batch
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.train.loop import (
    device_batch, make_optimizer, step_generator, train_step, write_host_ms)
from few_shot_transformer_tts_torch.utils import tracing

STEP_PARTS = ("train.forward", "train.loss", "train.backward",
              "train.optimizer")


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(window=-1):
    return tracing.windows()[window]["spans"]


def _batch(hp, b=4, t_in=12, t_out=16, seed=0):
    rng = np.random.RandomState(seed)
    tl = rng.randint(t_out // 2, t_out + 1, b).astype(np.int32)
    tl[0] = t_out
    mel = np.clip(rng.randn(b, t_out, hp.num_mels), -4, 4).astype(np.float32)
    mel[np.arange(t_out)[None, :] >= tl[:, None]] = 0.0
    return dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=np.full(b, t_in, np.int32), mel_targets=mel,
        target_lengths=tl, input_spk_ids=rng.randint(0, 4, b).astype(np.int32),
        input_language_vecs=np.eye(hp.max_num_language, dtype=np.float32)[
            rng.randint(0, 3, b)])


def test_self_time_is_the_duration_less_the_children():
    with tracing.span("data.outer"):
        time.sleep(0.01)
        with tracing.span("data.inner"):
            time.sleep(0.02)
        with tracing.span("data.inner"):
            time.sleep(0.01)
    spans = _spans()
    n, outer, outer_self = spans["data.outer"]
    m, inner, inner_self = spans["data.inner"]
    assert (n, m) == (1, 2)
    assert inner == inner_self >= 0.03
    assert outer >= 0.04
    assert outer_self == pytest.approx(outer - inner, abs=1e-9)
    assert 0.01 <= outer_self < outer


def test_a_new_window_at_each_profiler_start_and_stop():
    with tracing.span("data.a"):
        pass
    with _profile():
        with tracing.span("data.a"):
            pass
        tracing.count("data.frames", 3)
    tracing.count("data.frames", 5)
    with tracing.span("data.a"):
        pass
    ws = tracing.windows()
    assert [w["profiled"] for w in ws] == [False, True, False]
    assert [w["index"] for w in ws] == [0, 1, 2]
    assert [w["spans"]["data.a"][0] for w in ws] == [1, 1, 1]
    assert ws[1]["counters"] == {"data.frames": 3}
    assert ws[2]["counters"] == {"data.frames": 5}


def test_a_thread_idle_through_a_profile_joins_the_newest_window():
    go, done = threading.Event(), threading.Event()

    def worker():
        with tracing.span("ops.b"):
            pass
        go.wait()
        with tracing.span("ops.b"):
            pass
        done.set()
    thread = threading.Thread(target=worker)
    thread.start()
    with _profile():
        with tracing.span("data.a"):
            pass
    with tracing.span("data.a"):
        pass
    go.set()
    done.wait()
    thread.join()
    ws = tracing.windows()
    assert [w["profiled"] for w in ws] == [False, True, False]
    assert [{k: v[0] for k, v in w["spans"].items()} for w in ws] == \
        [{"ops.b": 1}, {"data.a": 1}, {"data.a": 1, "ops.b": 1}]


def test_no_record_function_without_a_profiler():
    with mock.patch.object(tracing, "record_function") as rf:
        for _ in range(3):
            with tracing.span("ops.x"):
                pass
        assert rf.call_count == 0
        with _profile():
            with tracing.span("ops.x"):
                pass
        rf.assert_called_once_with("ops.x")


def test_spans_are_nested_user_annotations_in_the_chrome_trace(tmp_path):
    with _profile() as prof:
        with tracing.span("synth.call"):
            with tracing.span("synth.frames"):
                with tracing.span("synth.frame"):
                    torch.ones(8).add_(1)
        with tracing.span("synth.call"):
            pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        if e.get("cat") == "user_annotation" and \
                tracing.is_program_span(e["name"]):
            ranges.setdefault(e["name"], []).append(e)
    assert {k: len(v) for k, v in ranges.items()} == \
        {"synth.call": 2, "synth.frames": 1, "synth.frame": 1}
    ranges = {k: v[0] for k, v in ranges.items()}
    for inner, outer in (("synth.frame", "synth.frames"),
                         ("synth.frames", "synth.call")):
        a, b = ranges[inner], ranges[outer]
        assert b["ts"] <= a["ts"] and \
            a["ts"] + a["dur"] <= b["ts"] + b["dur"]


def test_train_step_and_device_batch_spans():
    hp = small_test_config()
    model = init_weights_(ByteToMel(hp, device="cpu"), 0)
    optimizer, scheduler = make_optimizer(model, hp)
    host = _batch(hp)
    db = device_batch(host, hp, "cpu")
    spans = _spans()
    assert spans["data.device_batch"][0] == 1
    assert spans["data.h2d"][0] == 1
    assert spans["data.quantize"][0] == spans["data.dequantize"][0] == 1
    with _profile():
        train_step(model, optimizer, scheduler, db, hp,
                   step_generator(0, 0, "cpu"))
    w = tracing.windows()[-1]
    n, step, step_self = w["spans"]["train.step"]
    assert n == 1
    assert tracing.last_seconds() == pytest.approx(step, abs=1e-9)
    for part in STEP_PARTS:
        assert w["spans"][part][0] >= 1, part
    # the four parts are the step's children: they cover all but its self
    parts = sum(w["spans"][p][1] for p in STEP_PARTS)
    assert step_self == pytest.approx(step - parts, abs=1e-9)
    assert 0 <= step_self < step


class _Writer:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, value, step))


def _steps(n, ms):
    for _ in range(n):
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                time.sleep(ms * 1e-3)


def test_summary_writes_host_ms_a_step_since_the_last():
    writer = _Writer()
    _steps(2, 1)
    last = write_host_ms(writer, None, 2)
    assert [r[0] for r in writer.rows] == ["host/train.forward_ms",
                                           "host/train.step_ms"]
    assert all(r[1] >= 1.0 and r[2] == 2 for r in writer.rows)
    writer.rows.clear()
    _steps(3, 20)
    write_host_ms(writer, last, 5)
    got = dict((r[0], r[1]) for r in writer.rows)
    assert 20.0 <= got["host/train.forward_ms"] <= got["host/train.step_ms"]
    steps = tracing.windows()[-1]["spans"]["train.step"]
    assert steps[0] == 5
    assert got["host/train.step_ms"] < 1e3 * steps[1] / 3


def _stop_bias(model, value):
    with torch.no_grad():
        model.decoder.stop_net.bias.fill_(value)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("stop, frames, checks",
                         [(-1e4, 40, 2), (1e4, 16, 1)],
                         ids=["to_the_cap", "stops_at_once"])
def test_synthesis_spans_a_frame_per_step(fused, stop, frames, checks):
    hp = small_test_config(use_pallas_decode=fused)
    model = init_weights_(ByteToMel(hp, device="cpu"), 1).eval()
    _stop_bias(model, stop)
    batch = _batch(hp, b=3)
    out = synthesize_batch(model, batch, hp, deterministic=True,
                           collect_alignments=False, max_frames=40)
    w = tracing.windows()[-1]
    spans, counters = w["spans"], w["counters"]
    assert counters["synth.frame_steps"] == frames
    assert spans["synth.frame"][0] == frames
    assert spans["synth.stop_check"][0] == checks
    assert spans["synth.call"][0] == 1
    for part in ("synth.prepare", "synth.weights", "synth.encode",
                 "synth.frames", "synth.postnet", "synth.fetch"):
        assert spans[part][0] >= 1, part
    assert ("ops.decoder_frame_step" in spans) == fused
    if fused:
        assert spans["ops.decoder_frame_step"][0] == frames
    if stop < 0:
        assert out["mel_pre"].shape[1] == frames


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """mels.zip + metadata: 2 languages x 2 speakers x 6 utterances."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    rows, spk_to_id, lang_to_id = [], {}, {}
    with zipfile.ZipFile(root / "mels.zip", "w") as zf:
        for lang in ("en-us", "de-de"):
            lang_to_id[lang] = len(lang_to_id)
            for s in range(2):
                spk = "%s%d" % (lang[:2], s)
                spk_to_id[spk] = len(spk_to_id)
                for i in range(6):
                    name = "%s_%010d" % (spk, i)
                    t = int(rng.randint(8, 30))
                    buf = io.BytesIO()
                    np.save(buf, rng.randn(t, 20).astype(np.float32))
                    zf.writestr(name + ".npy", buf.getvalue())
                    rows.append("%s.npy|%d|hello %d|%s" % (name, t, i, lang))
    (root / "metadata.train.txt").write_text("\n".join(rows))
    return root, spk_to_id, lang_to_id


def test_feeder_counts_the_frames_and_padding_it_hands_out(corpus):
    root, spk_to_id, lang_to_id = corpus
    hp = default_config(bucket_size=12, data_warmup_steps=0,
                        batch_frame_limit=120, batch_frame_quad_limit=4000,
                        num_mels=20)
    feeder = Feeder(str(root / "mels.zip"), str(root / "metadata.train.txt"),
                    hparams=hp, spk_to_id=spk_to_id, lang_to_id=lang_to_id)
    while feeder.queue.qsize() < 5:     # produced on this thread
        feeder._enqueue_next_group()
    tracing.reset()
    got = [feeder.get_batch() for _ in range(5)]
    frames = sum(int(b["target_lengths"].sum()) for b in got)
    cells = sum(b["mel_targets"].shape[0] * b["mel_targets"].shape[1]
                for b in got)
    w = tracing.windows()[-1]
    assert w["counters"] == {"data.frames": frames,
                             "data.padded_frames": cells - frames}
    assert cells > frames
    assert w["spans"]["data.get_batch"][0] == 5


def _event(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "ph": "X"}


def test_idle_gaps_and_busy_share_on_a_hand_made_trace():
    events = [
        _event("user_annotation", "train.step", 0, 300),
        _event("user_annotation", "train.backward", 25, 75),
        _event("user_annotation", "ops.mha_backward", 35, 10, tid=2),
        _event("user_annotation", "gpubench.entry.mha_backward", 30, 20,
               tid=2),
        _event("user_annotation", "data.get_batch", 250, 40),
        _event("kernel", "k0", 0, 10),
        _event("kernel", "k1", 30, 10),
        _event("gpu_memcpy", "copy", 35, 10),     # overlaps k1: one busy run
        _event("kernel", "k2", 100, 20),
        _event("kernel", "k3", 180, 60),
        _event("kernel", "k4", 380, 20),          # after every span
        _event("kernel", "k5", 420, 20),
    ]
    gaps = tracing.idle_gaps(events, top=10)
    # gaps: 10-30 (in train.step), 45-100 (ops.mha_backward on thread 2
    # is innermost), 120-180 (train.step), 240-380 (train.step), 400-420
    # (no span)
    assert [(g[0], round(g[1] * 1e6), g[2]) for g in gaps] == [
        ("train.step", 140, 240), ("train.step", 60, 120),
        ("ops.mha_backward", 55, 45), ("other", 20, 400),
        ("train.step", 20, 10)]
    assert len(tracing.idle_gaps(events, top=2)) == 2
    busy = 10 + 15 + 20 + 60 + 20 + 20
    assert tracing.busy_share(events) == pytest.approx(busy / 440)
    assert tracing.busy_share(events[:5]) is None
