"""The port's training CLI data parallel on the CPU: two processes under
``python -m torch.distributed.run`` with ``--multihost --device cpu`` (gloo)
on the tiny corpus of tests/test_torch_train_cli.py.

- 2 steps with a checkpoint at step 2: ``model.ckpt-2.d`` holds one shard
  file per rank, each a proper subset of the train state, together covering
  every element once; each rank writes ``feeder_<rank>.pkl``; rank 0 alone
  writes the logs, and no ``.tmp`` is left;
- a second two-process run resumes from it and the per-rank feeder states
  and writes ``model.ckpt-4.d``;
- a one-process run (no ``--multihost``) resumes from ``model.ckpt-4.d`` and
  writes its next checkpoint as a single torch file.
"""

import logging
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from few_shot_transformer_tts_torch.train import cli
from few_shot_transformer_tts_torch.train.checkpoint import find_ckpt

from test_torch_train_cli import HP_SPEC, ROOT, corpus  # noqa: F401


def _argv(root, *extra):
    return ["--model-dir", str(root / "ddp" / "models"),
            "--log-dir", str(root / "ddp" / "logs"), "--data-dir", str(root),
            "--checkpoint_interval", "2", "--summary_interval", "2",
            "--log_interval", "2", "--hparams", HP_SPEC, "--device", "cpu",
            *extra]


def torchrun(root, max_steps):
    """The CLI under torchrun, 2 processes.  They go without matplotlib (the
    plots are optional) and TensorFlow (which TensorBoard, the scalar
    writer, loads where it is installed: seconds a process)."""
    shim = root / "shim"
    shim.mkdir(exist_ok=True)
    for name in ("tensorflow", "matplotlib"):
        (shim / (name + ".py")).write_text(
            "raise ImportError('%s is kept out of this run')\n" % name)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "few_shot_transformer_tts_torch.train",
           "--multihost", *_argv(root, "--max_steps", str(max_steps))]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [str(shim), str(ROOT)] +
        os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def runs(corpus):  # noqa: F811
    """The two two-process runs (to steps 2 and 4): their outputs."""
    return [torchrun(corpus, 2), torchrun(corpus, 4)]


def _tmp_files(root):
    return [os.path.join(d, f) for d, _, files in os.walk(root)
            for f in files if f.endswith(".tmp")]


def test_two_ranks_write_sharded_checkpoints_and_feeder_states(corpus, runs):
    models, logs = corpus / "ddp" / "models", corpus / "ddp" / "logs"
    assert sorted(os.listdir(models))[:2] == ["model.ckpt-2.d",
                                              "model.ckpt-4.d"]
    for step in (2, 4):
        ckpt = models / ("model.ckpt-%d.d" % step)
        names = sorted(os.listdir(ckpt))
        assert names == ["shard-0-of-2.pkl", "shard-1-of-2.pkl"]
        payloads = []
        for name in names:
            with open(ckpt / name, "rb") as f:
                payloads.append(pickle.load(f))
        keys = [set(p["leaves"]) for p in payloads]
        assert keys[0] and keys[1] and not keys[0] & keys[1]
        for p in payloads:
            assert p["step"] == step and p["world"] == 2
            for key, rec in p["leaves"].items():
                covered = np.zeros(rec["shape"], np.int64)
                for index, _ in rec["shards"]:
                    covered[tuple(index)] += 1
                assert np.all(covered == 1), key
        assert "step" in keys[0] | keys[1]
        assert any(k.startswith("opt_state/0/mu/") for k in keys[0])
        assert any(k.startswith("opt_state/0/mu/") for k in keys[1])
    assert (logs / "feeder_0.pkl").exists() and (logs / "feeder_1.pkl").exists()
    assert not _tmp_files(corpus / "ddp")
    # rank 0 alone logs to the file; rank 1 only to its stdout
    text = "".join(p.read_text() for p in logs.glob("outputs_*.log"))
    assert "process 0/2" in text and "process 1/2" not in text
    assert "process 1/2" in runs[0]
    assert all("[Step %d]" % s in text for s in range(1, 5))
    assert "Global batch shape" in text


def test_second_run_resumes_at_world_two(runs):
    assert "Restore from previous run" in runs[1]
    assert "step 2" in runs[1]


def test_one_process_resumes_from_the_two_rank_checkpoint(corpus, runs,
                                                          monkeypatch):
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)
    models = corpus / "ddp" / "models"
    assert find_ckpt(str(models)) == str(models / "model.ckpt-4.d")
    argv = _argv(corpus, "--max_steps", "6")
    argv[argv.index("--log-dir") + 1] = str(corpus / "ddp" / "logs_world1")
    model, step = cli.main(argv)
    assert step == 6
    assert (models / "model.ckpt-6").is_file()
    text = "".join(p.read_text() for p in (
        corpus / "ddp" / "logs_world1").glob("outputs_*.log"))
    assert "model.ckpt-4.d, step 4" in text and "[Step 5]" in text
