"""The port's training CLI with ``mesh_model_axis=2`` on the CPU, as the JAX
CLI runs a model axis (``tests/test_multiprocess.py:100``): two processes
under ``python -m torch.distributed.run`` with ``--multihost --device cpu``
form a ``(data=1, model=2)`` grid and run the replicated step on it, the
rows sharded over the data index, so both ranks train on the rows of a
one-process run.  Its per-step losses (dropout on) equal those of the
data-parallel run at world = data = 1, the CLI without ``--multihost``, to
the digits the log prints; each rank writes its shard file of
``model.ckpt-4.d`` and its feeder state.
"""

import logging
import os
import re
import subprocess
import sys

import pytest

from few_shot_transformer_tts_torch.train import cli

from test_torch_train_cli import HP_SPEC, ROOT, corpus  # noqa: F401


def _argv(root, run, *extra):
    return ["--model-dir", str(root / run / "models"),
            "--log-dir", str(root / run / "logs"), "--data-dir", str(root),
            "--checkpoint_interval", "4", "--summary_interval", "2",
            "--log_interval", "2", "--eval_steps", "100", "--device", "cpu",
            *extra]


def step_losses(log_dir):
    text = "".join(p.read_text() for p in log_dir.glob("outputs_*.log"))
    return re.findall(r"\[Step (\d+)\].*?loss=([0-9.]+)", text)


@pytest.fixture(scope="module")
def model_axis_run(corpus):  # noqa: F811
    """The CLI under torchrun, 2 processes, ``mesh_model_axis=2``; its
    output.  The processes go without matplotlib and TensorFlow (seconds a
    process where installed; the CLI does not need them)."""
    shim = corpus / "shim"
    shim.mkdir(exist_ok=True)
    for name in ("tensorflow", "matplotlib"):
        (shim / (name + ".py")).write_text(
            "raise ImportError('%s is kept out of this run')\n" % name)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m",
           "few_shot_transformer_tts_torch.train",
           "--multihost", *_argv(corpus, "tp", "--max_steps", "4",
                                 "--hparams", HP_SPEC + ",mesh_model_axis=2")]
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [str(shim), str(ROOT)] +
        os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    return proc.stdout + proc.stderr


def test_model_axis_losses_equal_the_data_parallel_run(corpus, model_axis_run,
                                                       monkeypatch):
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)
    _, step = cli.main(_argv(corpus, "dp", "--max_steps", "4", "--hparams",
                             HP_SPEC))
    assert step == 4
    want = step_losses(corpus / "dp" / "logs")
    got = step_losses(corpus / "tp" / "logs")
    assert [s for s, _ in want] == ["1", "2", "3", "4"]
    assert got == want
    assert "process 1/2" in model_axis_run


def test_model_axis_ranks_write_their_shards_and_feeder_states(
        corpus, model_axis_run):
    ckpt = corpus / "tp" / "models" / "model.ckpt-4.d"
    assert sorted(os.listdir(ckpt)) == ["shard-0-of-2.pkl", "shard-1-of-2.pkl"]
    logs = corpus / "tp" / "logs"
    assert (logs / "feeder_0.pkl").exists()
    assert (logs / "feeder_1.pkl").exists()
