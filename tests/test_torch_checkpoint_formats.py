"""The JAX package's checkpoints read by the port: its flax msgpack
``model.ckpt-<step>`` files (``train/flax_msgpack.py`` against flax's own
``to_bytes``/``msgpack_restore``), its sharded ``.d`` directories, and the
weight names both ways (``jax_variables_from_state_dict`` against the JAX
``convert_torch_state_dict``).  ``load_state`` must give the weights and
Adam moments of ``state_dict_from_jax_variables``/
``optimizer_state_from_jax`` bit for bit."""

import logging
import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.models.tacotron import \
    ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.train import checkpoint as jax_ckpt
from few_shot_transformer_tts_tpu.train.converter import \
    convert_torch_state_dict
from few_shot_transformer_tts_tpu.train.loop import create_state
from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.train import checkpoint as ckpt_lib
from few_shot_transformer_tts_torch.train import flax_msgpack
from few_shot_transformer_tts_torch.train.converter import (
    jax_variables_from_state_dict, optimizer_state_from_jax,
    state_dict_from_jax_variables)
from few_shot_transformer_tts_torch.train.loop import make_optimizer

from test_torch_weights import NO_CONDITIONING, example_batch, jax_variables


@pytest.fixture(scope="module")
def jax_state():
    """A small JAX TrainState at step 7 whose Adam moments and counts are
    random (numpy seed), as a trainer's checkpoint holds them."""
    hp = jax_cfg()
    state = create_state(JaxByteToMel(hp), hp, 0, example_batch(hp))
    state = jax.device_get(state)
    rng = np.random.RandomState(3)
    rand = lambda tree, lo: jax.tree.map(lambda a: rng.uniform(
        lo, 1.0, np.shape(a)).astype(np.float32), tree)
    adam, sched = state.opt_state
    opt_state = (adam._replace(count=np.asarray(7, np.int32),
                               mu=rand(adam.mu, -1.0),
                               nu=rand(adam.nu, 0.0)),
                 sched._replace(count=np.asarray(7, np.int32)))
    return state.replace(step=np.asarray(7, np.int32), opt_state=opt_state)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
            if not v:
                out[prefix + (k,)] = "empty"
        else:
            out[prefix + (k,)] = v
    return out


def _bits(leaf):
    """A leaf's dtype name, shape and bytes (bf16 as torch or ml_dtypes)."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return "bfloat16", tuple(leaf.shape), \
            leaf.view(torch.int16).numpy().tobytes()
    if isinstance(leaf, str):
        return leaf
    arr = np.asarray(leaf)
    return arr.dtype.name, arr.shape, arr.tobytes()


def assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert list(got) == list(want)
    for key in want:
        assert type(got[key]) is type(want[key]) or \
            isinstance(got[key], torch.Tensor), key
        assert _bits(got[key]) == _bits(want[key]), key


def _variant(state, case):
    if case == "bf16_leaf":
        params = jax.tree.map(lambda a: a, state.params)
        ln = params["decoder"]["decoder"]["output_layer_norm"]
        ln["scale"] = jnp.asarray(ln["scale"], jnp.bfloat16)
        return state.replace(params=params)
    if case == "npscalar":
        return state.replace(step=np.int32(7))
    if case == "empty_dict":
        return state.replace(batch_stats={})
    return state


@pytest.mark.parametrize("case", ["plain", "bf16_leaf", "npscalar",
                                  "empty_dict", "chunked"])
def test_msgpack_reader_matches_flax(jax_state, case, monkeypatch):
    if case == "chunked":      # leaves above 4 KB go out in pieces
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    state = _variant(jax_state, case)
    data = flax.serialization.to_bytes(state)
    if case == "chunked":
        assert flax_msgpack.CHUNKED.encode() in data
    got = flax_msgpack.loads(data)
    want = flax.serialization.msgpack_restore(data)
    assert_same_tree(got, want)
    if case == "npscalar":
        assert isinstance(got["step"], np.int32)
    else:
        assert got["step"].shape == () and got["step"].dtype == np.int32
    assert got["opt_state"]["0"]["count"].dtype == np.int32
    if case == "bf16_leaf":
        scale = got["params"]["decoder"]["decoder"]["output_layer_norm"][
            "scale"]
        assert scale.dtype == torch.bfloat16
    # the port writes the same bytes, and flax reads them back
    again = flax_msgpack.dumps(got)
    assert again == data
    assert_same_tree(flax.serialization.msgpack_restore(again), want)


def test_msgpack_writer_takes_torch_leaves():
    rng = np.random.RandomState(0)
    w = rng.randn(5, 3).astype(np.float32)
    tree = {"w": torch.from_numpy(w), "b": torch.ones(4, dtype=torch.bfloat16),
            "n": {"s": "x" * 40, "i": [0, -1, 127, 128, -33, 2 ** 33],
                  "f": 0.25, "z": 1 - 2j, "none": None, "t": True,
                  "raw": b"\x00" * 300, "e": {}}}
    back = flax.serialization.msgpack_restore(flax_msgpack.dumps(tree))
    np.testing.assert_array_equal(back["w"], w)
    assert str(back["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(back["b"], np.float32),
                                  np.ones(4, np.float32))
    assert back["n"] == {k: v for k, v in tree["n"].items()}


@pytest.mark.parametrize("data,what", [
    (b"\xc1", "0xc1"),
    (b"\xd4\x05\x00", "ext code 5"),
    (b"\xd6\xff\x00\x00\x00\x00", "ext code -1"),
    (b"\x82\xa1a", "ends"),
    (b"\x90\x90", "follow")])
def test_msgpack_reader_rejects_other_types(data, what):
    with pytest.raises(ValueError, match=what):
        flax_msgpack.loads(data)


@pytest.mark.parametrize("overrides", [{}, NO_CONDITIONING],
                         ids=["conditioned", "unconditioned"])
def test_jax_variables_from_state_dict_matches_jax(overrides):
    model = init_weights_(ByteToMel(small_test_config(**overrides),
                                    device="cpu"), 4)
    sd = model.state_dict()
    got = jax_variables_from_state_dict(sd)
    want = convert_torch_state_dict(sd)
    assert sorted(got) == sorted(want)
    for col in want:
        assert_same_tree(_sorted(got[col]), _sorted(want[col]))
    # and it inverts state_dict_from_jax_variables, bit for bit
    variables = jax_variables(5, **overrides)
    back = jax_variables_from_state_dict(
        state_dict_from_jax_variables(variables))
    for col in variables:
        assert_same_tree(_sorted(back[col]), _sorted(variables[col]))
    assert back["params"]["encoder"]["encoder"]["pe_scale"].shape == ()


def _sorted(tree):
    return {k: _sorted(tree[k]) if isinstance(tree[k], dict) else tree[k]
            for k in sorted(tree)}


def _port_model():
    return ByteToMel(small_test_config(), device="cpu")


def _expected(state):
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    model = _port_model()
    optimizer, _ = make_optimizer(model, small_test_config())
    adam = state.opt_state[0]
    return (state_dict_from_jax_variables(variables),
            optimizer_state_from_jax(adam.mu, adam.nu, int(adam.count),
                                     model, optimizer))


def _load_and_check(path, state):
    want_sd, want_optim = _expected(state)
    model = _port_model()
    hp = small_test_config()
    optimizer, scheduler = make_optimizer(model, hp)
    step = ckpt_lib.load_state(str(path), model, optimizer, scheduler)
    assert step == int(state.step)
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for name in want_sd:
        torch.testing.assert_close(got_sd[name], want_sd[name], rtol=0,
                                   atol=0, msg=name)
    got_optim = optimizer.state_dict()["state"]
    assert sorted(got_optim) == sorted(want_optim["state"])
    for i, want in want_optim["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got_optim[i][key], want[key], rtol=0,
                                       atol=0, msg="%s %s" % (i, key))
    # the schedule resumes at the step, as from a torch checkpoint
    assert scheduler.last_epoch == step
    lr = hp.max_lr * scheduler.lr_lambdas[0](step)
    assert [g["lr"] for g in optimizer.param_groups] == [lr]
    return model


def test_load_state_reads_a_jax_msgpack_checkpoint(jax_state, tmp_path):
    path = jax_ckpt.save_state(str(tmp_path), jax_state, 7)
    assert ckpt_lib.checkpoint_format(path) == "msgpack"
    _load_and_check(path, jax_state)


def _write_sharded(state, ckpt_dir, drop_rank=None, gap=False, world=2,
                   step=7):
    """``state`` as the JAX package's sharded format across two ranks: the
    leaves alternate between the ranks, and the largest leaf is split by
    rows between them (each rank records its slice)."""
    flat = jax_ckpt._flatten_state(state)
    keys = sorted(flat)
    big = max(keys, key=lambda k: np.asarray(flat[k]).size)
    os.makedirs(ckpt_dir, exist_ok=True)
    for rank in range(2):
        leaves = {}
        for key in keys[rank::2]:
            if key == big:
                continue
            arr = np.asarray(flat[key])
            leaves[key] = {"shape": arr.shape, "dtype": str(arr.dtype),
                           "shards": [(tuple(slice(None)
                                             for _ in arr.shape), arr)]}
        arr = np.asarray(flat[big])
        half = arr.shape[0] // 2
        rows = slice(0, half) if rank == 0 else \
            slice(half + (1 if gap else 0), arr.shape[0])
        leaves[big] = {"shape": arr.shape, "dtype": str(arr.dtype),
                       "shards": [((rows,) + tuple(slice(None) for _ in
                                                   arr.shape[1:]),
                                   arr[rows])]}
        if rank == drop_rank:
            continue
        with open(os.path.join(ckpt_dir, "shard-%d-of-%d.pkl"
                               % (rank, world)), "wb") as f:
            pickle.dump({"rank": rank, "world": world, "step": step,
                         "leaves": leaves}, f, protocol=4)
    return ckpt_dir


def test_load_state_reads_a_sharded_dir(jax_state, tmp_path):
    path = _write_sharded(jax_state, str(tmp_path / "model.ckpt-7.d"))
    assert ckpt_lib.checkpoint_format(path) == "sharded"
    # the JAX package reassembles the same state from it
    again = jax_ckpt.load_state(path, jax_state)
    assert_same_tree(flax.serialization.to_state_dict(jax.device_get(again)),
                     flax.serialization.to_state_dict(jax_state))
    tree = ckpt_lib.load_state_sharded(path)
    assert_same_tree(_sorted(tree), _sorted(
        flax.serialization.to_state_dict(jax_state)))
    _load_and_check(path, jax_state)


@pytest.mark.parametrize("fault,match", [
    ("missing", "expected 2 shard files, found 1"),
    ("gap", "shard coverage mismatch"),
    ("world", "expected 3 shard files, found 2"),
    ("empty", "no shard files")])
def test_sharded_dir_faults_raise(jax_state, tmp_path, fault, match):
    ckpt_dir = str(tmp_path / "model.ckpt-7.d")
    if fault == "empty":
        os.makedirs(ckpt_dir)
    else:
        _write_sharded(jax_state, ckpt_dir,
                       drop_rank=1 if fault == "missing" else None,
                       gap=fault == "gap", world=3 if fault == "world" else 2)
    with pytest.raises(ValueError, match=match):
        ckpt_lib.load_state(ckpt_dir, _port_model())


def test_sharded_step_mismatch_warns(jax_state, tmp_path, caplog):
    ckpt_dir = _write_sharded(jax_state, str(tmp_path / "model.ckpt-9.d"),
                              step=8)
    with caplog.at_level(logging.WARNING):
        step = ckpt_lib.load_state(ckpt_dir, _port_model())
    assert step == 7
    text = caplog.text
    assert "checkpoint dir says 8" in text and "name says 9" in text


def test_checkpoint_format_of_each_kind(jax_state, tmp_path):
    model = _port_model()
    zip_path = tmp_path / "model.ckpt-1"
    torch.save({"model": model.state_dict(), "step": 1}, str(zip_path))
    legacy = tmp_path / "model.ckpt-2"
    torch.save({"model": model.state_dict(), "step": 2}, str(legacy),
               _use_new_zipfile_serialization=False)
    msgpack_path = jax_ckpt.save_state(str(tmp_path), jax_state, 3)
    sharded = _write_sharded(jax_state, str(tmp_path / "model.ckpt-4.d"))
    assert [ckpt_lib.checkpoint_format(str(p)) for p in
            (zip_path, legacy, msgpack_path, sharded)] == \
        ["torch", "torch", "msgpack", "sharded"]
    assert ckpt_lib.load_state(str(legacy), _port_model()) == 2
    bogus = tmp_path / "model.ckpt-5"
    for raw in (b"", b"GARBAGE", b"\x93\x01\x02\x03"):
        bogus.write_bytes(raw)
        with pytest.raises(ValueError, match="a torch file, a flax msgpack "
                           "file or a sharded .d directory"):
            ckpt_lib.load_state(str(bogus), _port_model())
