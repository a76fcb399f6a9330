"""The port's training runtime flags and crash path on the CPU, at the tiny
widths of tests/test_torch_train_cli.py:

- ``--profile_dir`` with ``--profile_step 2 --profile_n_steps 2`` writes one
  Chrome trace, ``trace_rank0_steps2-3.json``, with exactly two
  ``train.step`` ranges, each holding ``train.forward``, ``train.backward``
  and ``train.optimizer``, and logs its path, the busy share and the idle
  gaps;
- ``--mirror_interval``, ``--profile_dir``, ``--profile_step`` and
  ``--profile_n_steps`` parse as the JAX package's root ``train.py`` parses
  them (defaults 1000, None, 50, 5);
- ``crash_save`` writes the live state when it can be fetched, and the host
  mirror (at its own step) when the copy to the host raises or the
  optimizer step failed part way, logging "falling back to the host
  mirror"; at world 2 each rank writes its shard file of the mirror;
- a world-2 crash that only some ranks reach (one rank's live state, or one
  rank's live state and the other's mirror) leaves ``.d`` directories that
  lack a shard file: ``find_ckpt`` skips them with a warning, and the CLI
  resumes from the last whole checkpoint;
- the CLI with ``--mirror_interval 2`` and an optimizer step that raises at
  step 5 leaves the mirror's ``model.ckpt-4`` (the crash's own state is not
  saved), and a resume from it runs.
"""

import glob
import importlib.util
import json
import logging
import os

import pytest
import torch

from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.train import checkpoint as ckpt_lib
from few_shot_transformer_tts_torch.train import cli
from few_shot_transformer_tts_torch.train.loop import (
    StateUpdateError, crash_save, make_optimizer)

from test_torch_train_cli import HP_SPEC, ROOT, corpus  # noqa: F401


@pytest.fixture(autouse=True)
def _keep_root_logger(monkeypatch):
    """The CLI replaces the root logger's handlers; restore them after."""
    monkeypatch.setattr(logging.root, "handlers", list(logging.root.handlers))
    monkeypatch.setattr(logging.root, "level", logging.root.level)


def _argv(root, run, *extra):
    return ["--model-dir", str(root / run / "models"),
            "--log-dir", str(root / run / "logs"), "--data-dir", str(root),
            "--checkpoint_interval", "100", "--summary_interval", "100",
            "--log_interval", "2", "--eval_steps", "100", "--hparams",
            HP_SPEC, "--device", "cpu", *extra]


def _log(root, run):
    return "".join(open(p).read() for p in glob.glob(
        str(root / run / "logs" / "outputs_*.log")))


def test_profile_flags_trace_exactly_the_window(corpus):  # noqa: F811
    trace_dir = corpus / "prof" / "trace"
    _, step = cli.main(_argv(corpus, "prof", "--max_steps", "5",
                             "--profile_dir", str(trace_dir),
                             "--profile_step", "2", "--profile_n_steps", "2"))
    assert step == 5
    assert os.listdir(trace_dir) == ["trace_rank0_steps2-3.json"]
    with open(trace_dir / "trace_rank0_steps2-3.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    steps = [e for e in ranges if e["name"] == "train.step"]
    assert len(steps) == 2
    for step in steps:
        inside = {e["name"] for e in ranges
                  if e["tid"] == step["tid"] and step["ts"] <= e["ts"] and
                  e["ts"] + e["dur"] <= step["ts"] + step["dur"]}
        assert {"train.forward", "train.backward",
                "train.optimizer"} <= inside
    log = _log(corpus, "prof")
    assert "Profiler trace written to %s" % (
        trace_dir / "trace_rank0_steps2-3.json") in log
    assert "Traced steps: device busy" in log


def test_runtime_flags_parse_as_the_jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", os.path.join(str(ROOT), "train.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    base = ["--model-dir", "m", "--log-dir", "l", "--data-dir", "d"]
    flags = ("mirror_interval", "profile_dir", "profile_step",
             "profile_n_steps")
    for argv in ([], ["--mirror_interval", "7", "--profile_dir", "p",
                      "--profile_step", "3", "--profile_n_steps", "2"]):
        ours = cli.build_parser().parse_args(base + argv)
        theirs = jax_cli.build_parser().parse_args(base + argv)
        assert {f: getattr(ours, f) for f in flags} == \
            {f: getattr(theirs, f) for f in flags}
    assert cli.build_parser().parse_args(base).mirror_interval == 1000


class _Feeder:
    def state_dict(self):
        return {"cursor": 3}


def _state(seed, root=None):
    """A model, Adam and its schedule from ``seed``; ``root/logs`` made, as
    the train loop makes its log dir."""
    if root is not None:
        (root / "logs").mkdir(exist_ok=True)
    hp = small_test_config()
    model = init_weights_(ByteToMel(hp, device="cpu"), seed)
    optimizer, scheduler = make_optimizer(model, hp)
    return model, optimizer, scheduler


def _weights(path):
    return torch.load(path, weights_only=True)["model"]


def test_crash_save_writes_the_live_state_when_it_can(tmp_path):
    model, optimizer, scheduler = _state(1, tmp_path)
    mirror = ckpt_lib.snapshot(model, optimizer, scheduler, 4)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    crash_save(str(tmp_path / "logs"), str(tmp_path), 0, _Feeder(), model,
               optimizer, scheduler, 5, mirror=mirror)
    assert sorted(os.listdir(tmp_path)) == ["logs", "model.ckpt-5"]
    assert (tmp_path / "logs" / "feeder_0.pkl").exists()
    saved = _weights(tmp_path / "model.ckpt-5")
    for name, value in model.state_dict().items():
        assert torch.equal(saved[name], value), name


@pytest.mark.parametrize("fault", ["copy_raises", "half_updated"])
def test_crash_save_falls_back_to_the_mirror(tmp_path, monkeypatch, caplog,
                                             fault):
    model, optimizer, scheduler = _state(1, tmp_path)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    mirror = ckpt_lib.snapshot(model, optimizer, scheduler, 4)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    live_ok = True
    if fault == "copy_raises":
        def unfetchable(obj):
            raise RuntimeError("CUDA error: an illegal memory access")
        monkeypatch.setattr(ckpt_lib, "host_copy", unfetchable)
    else:
        live_ok = False
    with caplog.at_level(logging.INFO):
        crash_save(str(tmp_path / "logs"), str(tmp_path), 0, _Feeder(),
                   model, optimizer, scheduler, 5, mirror=mirror,
                   live_ok=live_ok)
    assert sorted(os.listdir(tmp_path)) == ["logs", "model.ckpt-4"]
    assert (tmp_path / "logs" / "feeder_0.pkl").exists()
    saved = _weights(tmp_path / "model.ckpt-4")
    for name, value in want.items():
        assert torch.equal(saved[name], value), name
    text = caplog.text
    assert "falling back to the host mirror" in text
    assert "saved from the host mirror at step 4" in text


def test_crash_save_at_world_two_writes_each_ranks_mirror_share(
        tmp_path, monkeypatch):
    model, optimizer, scheduler = _state(2, tmp_path)
    mirrors = [ckpt_lib.snapshot(model, optimizer, scheduler, 4, True, r, 2)
               for r in range(2)]
    def unfetchable(*args):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(ckpt_lib, "port_train_leaves", unfetchable)
    for rank in range(2):
        crash_save(str(tmp_path / "logs"), str(tmp_path), rank, _Feeder(),
                   model, optimizer, scheduler, 5, world=2,
                   mirror=mirrors[rank])
    monkeypatch.undo()
    ckpt = tmp_path / "model.ckpt-4.d"
    assert sorted(os.listdir(ckpt)) == ["shard-0-of-2.pkl", "shard-1-of-2.pkl"]
    fresh, opt2, sched2 = _state(9)
    assert ckpt_lib.load_state(str(ckpt), fresh, opt2, sched2) == 4
    for name, value in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[name], value), name


def test_cli_crash_saves_the_mirror_and_resumes(corpus, monkeypatch):  # noqa
    calls = []
    step = torch.optim.Adam.step

    def failing_step(self, *a, **kw):
        calls.append(1)
        if len(calls) == 5:
            # part of the update lands, then the step fails
            with torch.no_grad():
                next(iter(self.param_groups[0]["params"])).add_(1.0)
            raise RuntimeError("injected fault in the optimizer step")
        return step(self, *a, **kw)
    monkeypatch.setattr(torch.optim.Adam, "step", failing_step)
    argv = _argv(corpus, "crash", "--mirror_interval", "2")
    with pytest.raises(StateUpdateError):
        cli.main(argv + ["--max_steps", "8"])
    models = corpus / "crash" / "models"
    assert sorted(os.listdir(models)) == ["model.ckpt-4"]
    assert torch.load(models / "model.ckpt-4", weights_only=True)[
        "step"] == 4
    log = _log(corpus, "crash")
    assert "falling back to the host mirror" in log
    monkeypatch.setattr(torch.optim.Adam, "step", step)
    _, last = cli.main(argv + ["--max_steps", "6"])
    assert last == 6
    assert "Restore from previous run at %s from %s, step 4" % (
        models, models / "model.ckpt-4") in _log(corpus, "crash")


@pytest.mark.parametrize("crashed", ["one_rank_live", "live_and_mirror"])
def test_partial_crash_directories_are_skipped_on_resume(corpus, crashed):  # noqa
    run = "partial_" + crashed
    argv = _argv(corpus, run)
    argv[argv.index("--checkpoint_interval") + 1] = "2"
    cli.main(argv + ["--max_steps", "2"])
    models = corpus / run / "models"
    # rank 1 of a world-2 run reached crash_save at step 5 and rank 0 did
    # not, or rank 0 fell back to its step-4 mirror
    (corpus / run / "crash").mkdir()
    model, optimizer, scheduler = _state(3, corpus / run / "crash")
    logs = str(corpus / run / "crash" / "logs")
    crash_save(logs, str(models), 1, _Feeder(), model, optimizer, scheduler,
               5, world=2)
    partial = ["model.ckpt-5.d"]
    if crashed == "live_and_mirror":
        mirror = ckpt_lib.snapshot(model, optimizer, scheduler, 4, True, 0, 2)
        crash_save(logs, str(models), 0, _Feeder(), model, optimizer,
                   scheduler, 5, world=2, mirror=mirror, live_ok=False)
        partial.insert(0, "model.ckpt-4.d")
    assert sorted(os.listdir(models)) == ["model.ckpt-2"] + partial
    assert ckpt_lib.find_ckpt(str(models)) == str(models / "model.ckpt-2")
    _, last = cli.main(argv + ["--max_steps", "4"])
    assert last == 4
    log = _log(corpus, run)
    assert "Restore from previous run at %s from %s, step 2" % (
        models, models / "model.ckpt-2") in log
    for name in partial:
        assert "Skipping incomplete checkpoint %s" % (models / name) in log
