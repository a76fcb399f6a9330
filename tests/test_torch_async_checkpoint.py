"""The port's ``AsyncCheckpointer`` (train/checkpoint.py), the single-file
half of the JAX package's (its tests/test_checkpoint_sharded.py:94-117; the
sharded half is tests/test_torch_checkpoint_sharded.py):

- an async save loads to the tensors ``save_state`` writes, model,
  optimizer, scheduler and step;
- a failed write (a file where the model dir must go) makes ``wait()``
  return False, logs the error and raises nothing;
- a second ``save`` joins the write in flight before it starts its own;
- an optimizer step taken while the write is in flight does not reach the
  file (the host copy is taken on the caller's thread);
- the train CLI writes every checkpoint through the writer, and a run cut
  at a checkpoint step (a segment boundary) and started again resumes bit
  for bit as from the same state written by ``save_state``, with the LR
  schedule of an uninterrupted run.
"""

import io
import json
import logging
import os
import re
import shutil
import threading
import zipfile

import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch.config import default_config, \
    small_test_config
from few_shot_transformer_tts_torch.models.tacotron import ByteToMel, \
    init_weights_
from few_shot_transformer_tts_torch.train import checkpoint as ckpt_lib
from few_shot_transformer_tts_torch.train import cli
from few_shot_transformer_tts_torch.train.loop import (
    device_batch, make_optimizer, step_generator, train_step)

HP_SPEC = ("vocab_size=300,embed_size=32,encoder_hidden=32,decoder_hidden=48,"
           "n_encoder_layer=2,n_decoder_layer=2,n_attention_head=4,"
           "prenet_hidden=16,postnet_hidden=24,n_postnet_layer=3,num_mels=20,"
           "max_num_speaker=16,speaker_embedding_size=8,max_num_language=10,"
           "language_embedding_size=8,max_generation_frames=12,"
           "input_length_multiple=8,target_length_multiple=8,"
           "batch_size_multiple=2,use_bfloat16=False,bucket_size=16,"
           "data_warmup_steps=0,n_iter=4")
STEP_RE = re.compile(r"\[Step (\d+)\] .*?lr=([\d.]+), loss=([\d.]+)")


def _batch(hp, seed=0, b=4, t_in=12, t_out=16):
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


@pytest.fixture()
def state():
    """A small model, its Adam and schedule after one step (moments set)."""
    hp = small_test_config()
    model = init_weights_(ByteToMel(hp, device="cpu"), 3)
    optimizer, scheduler = make_optimizer(model, hp)
    batch = device_batch(_batch(hp), hp, "cpu")
    step = lambda s: train_step(model, optimizer, scheduler, batch, hp,
                                step_generator(0, s, "cpu"))
    step(0)
    return model, optimizer, scheduler, step


def _assert_same(a, b, where="checkpoint"):
    """Equal nested checkpoint dicts: tensors bit for bit, the rest =="""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a.cpu(), b.cpu()), where
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_same(a[k], b[k], "%s/%s" % (where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, "%s/%d" % (where, i))
    else:
        assert a == b, where


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_async_save_loads_to_the_tensors_of_save_state(state, tmp_path):
    model, optimizer, scheduler, _ = state
    sync = ckpt_lib.save_state(str(tmp_path / "sync"), model, optimizer,
                               scheduler, 7)
    saver = ckpt_lib.AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), model, optimizer, scheduler, 7)
    assert saver.wait()
    path = tmp_path / "async" / "model.ckpt-7"
    assert sorted(os.listdir(tmp_path / "async")) == ["model.ckpt-7"]
    _assert_same(_load(sync), _load(path))
    # and through the loader, into a fresh model, optimizer and schedule
    hp = small_test_config()
    fresh = init_weights_(ByteToMel(hp, device="cpu"), 4)
    opt2, sched2 = make_optimizer(fresh, hp)
    assert ckpt_lib.load_state(str(path), fresh, opt2, sched2) == 7
    _assert_same(model.state_dict(), fresh.state_dict())
    _assert_same(optimizer.state_dict(), opt2.state_dict())
    _assert_same(scheduler.state_dict(), sched2.state_dict())


def test_failed_write_returns_false_and_raises_nothing(state, tmp_path,
                                                       caplog):
    model, optimizer, scheduler, _ = state
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("a file where the model dir must go")
    saver = ckpt_lib.AsyncCheckpointer()
    saver.save(str(blocker / "models"), model, optimizer, scheduler, 1)
    with caplog.at_level(logging.ERROR):
        assert not saver.wait()      # logged, not raised: training goes on
    assert "Async checkpoint write failed" in caplog.text
    assert saver.wait()              # the error is reported once
    # the next save after a failed one still writes
    saver.save(str(tmp_path / "ok"), model, optimizer, scheduler, 2)
    assert saver.wait()
    assert (tmp_path / "ok" / "model.ckpt-2").exists()


def test_a_second_save_joins_the_first(state, tmp_path, monkeypatch):
    model, optimizer, scheduler, _ = state
    release = threading.Event()
    events = []
    real = ckpt_lib.write_state

    def gated(model_dir, st):
        events.append(("start", st["step"]))
        if st["step"] == 1:
            assert release.wait(30)
        real(model_dir, st)
        events.append(("landed", st["step"]))
    monkeypatch.setattr(ckpt_lib, "write_state", gated)
    saver = ckpt_lib.AsyncCheckpointer()
    saver.save(str(tmp_path), model, optimizer, scheduler, 1)
    second = threading.Thread(target=saver.save, args=(
        str(tmp_path), model, optimizer, scheduler, 2))
    second.start()
    second.join(0.5)
    # the second save is held behind the first write
    assert second.is_alive() and ("start", 2) not in events
    release.set()
    second.join(30)
    assert saver.wait()
    assert events == [("start", 1), ("landed", 1), ("start", 2),
                      ("landed", 2)]
    assert {"model.ckpt-1", "model.ckpt-2"} <= set(os.listdir(tmp_path))


def test_a_step_taken_while_the_write_is_in_flight_does_not_reach_it(
        state, tmp_path, monkeypatch):
    model, optimizer, scheduler, step = state
    before = ckpt_lib.host_copy({"model": model.state_dict(),
                                 "optim": optimizer.state_dict(),
                                 "sched": scheduler.state_dict()})
    started, release = threading.Event(), threading.Event()
    real = ckpt_lib.write_state

    def gated(model_dir, st):
        started.set()
        assert release.wait(30)
        real(model_dir, st)
    monkeypatch.setattr(ckpt_lib, "write_state", gated)
    saver = ckpt_lib.AsyncCheckpointer()
    saver.save(str(tmp_path), model, optimizer, scheduler, 1)
    assert started.wait(30)
    step(1)                          # updates the parameters in place
    changed = [k for k, v in model.state_dict().items()
               if not torch.equal(v, before["model"][k])]
    assert len(changed) > 10
    release.set()
    assert saver.wait()
    written = _load(tmp_path / "model.ckpt-1")
    for key in ("model", "optim", "sched"):
        _assert_same(before[key], written[key], key)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("async_cli")
    rng = np.random.RandomState(1)
    rows, spk_to_id, lang_to_id = [], {}, {}
    with zipfile.ZipFile(root / "mels.zip", "w") as zf:
        for lang in ["en-us", "de-de"]:
            lang_to_id[lang] = len(lang_to_id)
            spk = lang[:2] + "0"
            spk_to_id[spk] = len(spk_to_id)
            for i in range(12):
                name = "%s_%010d" % (spk, i)
                t = int(rng.randint(8, 30))
                buf = io.BytesIO()
                np.save(buf, np.clip(rng.randn(t, 20), -4, 4).astype(
                    np.float32))
                zf.writestr(name + ".npy", buf.getvalue())
                rows.append("%s.npy|%d|hello %d|%s" % (name, t, i, lang))
    (root / "metadata.train.txt").write_text("\n".join(rows))
    (root / "metadata.eval.txt").write_text("\n".join(rows[:2]))
    (root / "lang_id.json").write_text(json.dumps(lang_to_id))
    (root / "spk_id.json").write_text(json.dumps(spk_to_id))
    return root


@pytest.fixture(autouse=True)
def _keep_root_logger(monkeypatch):
    """The CLI replaces the root logger's handlers; restore them after."""
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)


def _run(root, run, max_steps):
    _, step = cli.main([
        "--model-dir", str(root / run / "models"),
        "--log-dir", str(root / run / "logs"), "--data-dir", str(root),
        "--checkpoint_interval", "3", "--summary_interval", "2",
        "--log_interval", "2", "--eval_steps", "99", "--hparams", HP_SPEC,
        "--device", "cpu", "--max_steps", str(max_steps)])
    assert step == max_steps
    return root / run


def _steps(run):
    """{step: (lr, loss)} from the run's log lines."""
    out = {}
    for path in sorted((run / "logs").glob("outputs_*.log")):
        for m in STEP_RE.finditer(path.read_text()):
            out[int(m.group(1))] = (m.group(2), m.group(3))
    return out


def test_cli_resumes_bit_for_bit_at_a_segment_boundary(corpus, monkeypatch):
    saves = []
    real_save = ckpt_lib.AsyncCheckpointer.save

    def counted(self, model_dir, model, optimizer, scheduler, step, **kw):
        saves.append(step)
        return real_save(self, model_dir, model, optimizer, scheduler, step,
                         **kw)
    monkeypatch.setattr(ckpt_lib.AsyncCheckpointer, "save", counted)
    monkeypatch.setattr(ckpt_lib, "save_state", None)   # no sync save left
    whole = _run(corpus, "whole", 6)
    # segment 1 stops at the checkpoint step, as a segmented run does
    seg = _run(corpus, "segmented", 3)
    assert saves == [3, 6, 3]
    assert sorted(os.listdir(seg / "models")) == ["model.ckpt-3"]
    monkeypatch.undo()

    # the same state written by save_state, beside the async file
    sync = corpus / "sync"
    shutil.copytree(seg, sync)
    hp = default_config().parse(HP_SPEC)
    model = init_weights_(ByteToMel(hp, device="cpu"), 9)
    optimizer, scheduler = make_optimizer(model, hp)
    assert ckpt_lib.load_state(str(seg / "models" / "model.ckpt-3"), model,
                               optimizer, scheduler) == 3
    os.remove(sync / "models" / "model.ckpt-3")
    ckpt_lib.save_state(str(sync / "models"), model, optimizer, scheduler, 3)

    _run(corpus, "segmented", 6)
    _run(corpus, "sync", 6)
    for run in (whole, seg, sync):
        assert not [f for f in os.listdir(run / "models")
                    if f.endswith(".tmp")]
    _assert_same(_load(sync / "models" / "model.ckpt-6"),
                 _load(seg / "models" / "model.ckpt-6"))
    resumed, from_sync, straight = _steps(seg), _steps(sync), _steps(whole)
    assert sorted(resumed) == list(range(1, 7))
    assert [resumed[s] for s in (4, 5, 6)] == \
        [from_sync[s] for s in (4, 5, 6)]
    # the schedule continues across the boundary as in one run
    assert [resumed[s][0] for s in range(1, 7)] == \
        [straight[s][0] for s in range(1, 7)]
