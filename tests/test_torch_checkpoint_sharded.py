"""The port's sharded checkpoint writer (train/checkpoint.py
``snapshot_local_shards``, ``save_state_sharded``, ``AsyncCheckpointer.save(
..., sharded=True)``), the counterpart of the JAX package's
(its tests/test_checkpoint_sharded.py and
tests/test_multiprocess.py::test_sharded_checkpoint_multiprocess):

- each rank's file holds a proper subset of the leaves, and together the
  files cover every element of the train state once;
- the port reads the directory back into its model, Adam and schedule bit
  for bit (all but ``num_batches_tracked``, which the format lacks, as
  the JAX package's), whether it was written at world 2 or world 1;
- the JAX package's ``load_state_sharded`` reads the port's directory into a
  ``create_state`` template, equal to the port's state: params,
  batch_stats, Adam ``mu``/``nu``/``count``, the schedule's count and step;
- each leaf's owner is the rank the JAX package's ``_owner_device`` picks
  with one device per process;
- a missing shard raises, in the port and in the JAX package;
- the async writer's sharded half writes the values of the moment of the
  save while the next step updates the model in place, and a failed write
  returns False from ``wait()``.
"""

import os
import pickle
import threading
import types

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.models.tacotron import \
    ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.train import checkpoint as jax_ckpt
from few_shot_transformer_tts_tpu.train.loop import create_state
from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.train import checkpoint as ckpt_lib
from few_shot_transformer_tts_torch.train.converter import \
    jax_train_state_from_port
from few_shot_transformer_tts_torch.train.loop import (
    device_batch, make_optimizer, step_generator, train_step)

from test_torch_weights import example_batch

STEP = 2


@pytest.fixture()
def state():
    """A small model, its Adam and schedule after two steps, and a function
    that takes one more step."""
    hp = small_test_config()
    model = init_weights_(ByteToMel(hp, device="cpu"), 3)
    optimizer, scheduler = make_optimizer(model, hp)
    batch = device_batch(example_batch(hp), hp, "cpu")
    step = lambda s: train_step(model, optimizer, scheduler, batch, hp,
                                step_generator(0, s, "cpu"))
    for s in range(STEP):
        step(s)
    return model, optimizer, scheduler, step


def write(state, model_dir, world, step=STEP):
    model, optimizer, _, _ = state
    for rank in range(world):
        shards = ckpt_lib.snapshot_local_shards(model, optimizer, step, rank,
                                                world)
        path = ckpt_lib.save_state_sharded(str(model_dir), shards, step,
                                           rank, world)
    return path


def _payloads(ckpt_dir):
    out = []
    for name in sorted(os.listdir(ckpt_dir)):
        with open(os.path.join(ckpt_dir, name), "rb") as f:
            out.append((name, pickle.load(f)))
    return out


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def test_rank_files_are_proper_subsets_covering_every_element_once(
        state, tmp_path):
    path = write(state, tmp_path, world=2)
    assert path == str(tmp_path / "model.ckpt-2.d")
    payloads = _payloads(path)
    assert [n for n, _ in payloads] == ["shard-0-of-2.pkl",
                                        "shard-1-of-2.pkl"]
    want = _flat(jax_train_state_from_port(*state[:2], STEP))
    assert {"step", "opt_state/0/count", "opt_state/1/count"} <= set(want)
    assert any(k.startswith("batch_stats/") for k in want)
    seen = {}
    for rank, (_, p) in enumerate(payloads):
        assert (p["rank"], p["world"], p["step"]) == (rank, 2, STEP)
        keys = set(p["leaves"])
        assert keys and keys < set(want)          # a proper subset
        for key, rec in p["leaves"].items():
            assert key not in seen, key            # one owner per leaf
            seen[key] = rec
    assert set(seen) == set(want)
    for key, rec in seen.items():
        covered = np.zeros(rec["shape"], np.int64)
        for index, data in rec["shards"]:
            covered[tuple(index)] += 1
            np.testing.assert_array_equal(data, want[key][tuple(index)])
        assert rec["dtype"] == str(want[key].dtype)
        assert np.all(covered == 1), key


def _assert_same(a, b, where="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
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


@pytest.mark.parametrize("world", [1, 2])
def test_port_reloads_bit_for_bit(state, tmp_path, world):
    model, optimizer, scheduler, _ = state
    path = write(state, tmp_path, world)
    assert ckpt_lib.find_ckpt(str(tmp_path)) == path
    hp = small_test_config()
    fresh = init_weights_(ByteToMel(hp, device="cpu"), 4)
    opt2, sched2 = make_optimizer(fresh, hp)
    assert ckpt_lib.load_state(path, fresh, opt2, sched2) == STEP
    # the JAX format has no num_batches_tracked (a count the masked
    # BatchNorm never reads): it stays the fresh model's
    counts = [k for k in model.state_dict() if k.endswith("_tracked")]
    assert counts and all(int(fresh.state_dict()[k]) == 0 for k in counts)
    _assert_same({k: v for k, v in model.state_dict().items()
                  if k not in counts},
                 {k: v for k, v in fresh.state_dict().items()
                  if k not in counts}, "model")
    _assert_same(optimizer.state_dict(), opt2.state_dict(), "optim")
    assert sched2.last_epoch == scheduler.last_epoch
    assert sched2.get_last_lr() == scheduler.get_last_lr()


@pytest.mark.parametrize("world", [1, 2])
def test_jax_load_state_sharded_reads_the_port_dir(state, tmp_path, world):
    path = write(state, tmp_path, world)
    hp = jax_cfg()
    template = jax.device_get(create_state(JaxByteToMel(hp), hp, 0,
                                           example_batch(hp)))
    got = _flat(flax.serialization.to_state_dict(
        jax.device_get(jax_ckpt.load_state_sharded(path, template))))
    want = _flat(jax_train_state_from_port(*state[:2], STEP))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert int(got["step"]) == STEP
    assert int(got["opt_state/0/count"]) == STEP
    assert int(got["opt_state/1/count"]) == STEP
    assert any(np.abs(got[k]).max() > 0 for k in got
               if k.startswith("opt_state/0/nu/"))


def test_leaf_owner_is_the_jax_owner_with_one_device_per_process():
    devices = [types.SimpleNamespace(id=i) for i in range(2)]
    hp = small_test_config()
    model = ByteToMel(hp, device="cpu")
    optimizer, _ = make_optimizer(model, hp)
    leaves = _flat(jax_train_state_from_port(model, optimizer, 0))
    owners = []
    for key, arr in leaves.items():
        index = tuple(slice(None) for _ in arr.shape)
        want = jax_ckpt._owner_device(key, index, devices).id
        owners.append(ckpt_lib.leaf_owner(key, arr.shape, 2))
        assert owners[-1] == want, key
    assert 0 < sum(owners) < len(owners)


def test_missing_shard_raises(state, tmp_path):
    path = write(state, tmp_path, world=2)
    os.remove(os.path.join(path, "shard-1-of-2.pkl"))
    with pytest.raises(ValueError, match="expected 2 shard files, found 1"):
        ckpt_lib.load_state(path, ByteToMel(small_test_config(),
                                            device="cpu"))
    hp = jax_cfg()
    template = jax.device_get(create_state(JaxByteToMel(hp), hp, 0,
                                           example_batch(hp)))
    with pytest.raises(ValueError):
        jax_ckpt.load_state_sharded(path, template)


def test_async_sharded_save_writes_the_values_of_the_save(
        state, tmp_path, monkeypatch):
    model, optimizer, _, step = state
    before = {k: np.copy(v) for k, v in _flat(
        jax_train_state_from_port(model, optimizer, STEP)).items()}
    started, release = threading.Event(), threading.Event()
    real = ckpt_lib.save_state_sharded

    def gated(*args):
        started.set()
        assert release.wait(30)
        return real(*args)
    monkeypatch.setattr(ckpt_lib, "save_state_sharded", gated)
    savers = [ckpt_lib.AsyncCheckpointer() for _ in range(2)]
    for rank, saver in enumerate(savers):
        saver.save(str(tmp_path), model, optimizer, state[2], STEP,
                   sharded=True, rank=rank, world=2)
    assert started.wait(30)
    step(STEP)                       # updates the parameters in place
    after = _flat(jax_train_state_from_port(model, optimizer, STEP + 1))
    moved = [k for k in after if k.startswith("params/") and
             not np.array_equal(after[k], before[k])]
    assert len(moved) > 10
    release.set()
    assert all(saver.wait() for saver in savers)
    path = str(tmp_path / "model.ckpt-2.d")
    assert sorted(os.listdir(path)) == ["shard-0-of-2.pkl",
                                        "shard-1-of-2.pkl"]
    tree = _flat(ckpt_lib.load_state_sharded(path))
    assert set(tree) == set(before)
    for key, value in tree.items():
        np.testing.assert_array_equal(value, before[key], err_msg=key)


def test_async_sharded_write_failure_returns_false(state, tmp_path):
    model, optimizer, scheduler, _ = state
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("a file where the model dir must go")
    saver = ckpt_lib.AsyncCheckpointer()
    saver.save(str(blocker / "models"), model, optimizer, scheduler, 1,
               sharded=True, rank=0, world=2)
    assert not saver.wait()
