"""Tensor parallelism of the port over the model axis of the ``(data, model)``
grid (``parallel/sharding_rules.py``, ``parallel/mesh.py:make_grid``), on
gloo CPU ranks (fp32, small_test_config: 4 heads, 2 a model rank).

This file runs itself as the ranks' worker script, as
``tests/test_torch_ddp.py`` does: two ranks at ``model=2`` and four at
``data=2, model=2`` (rows split 3/5 over the data index and cropped per
rank, the same rows on both ranks of a model group), 3 Adam steps each:

- every rank's losses are equal, and within rtol 1e-5 of the world-1 port
  over the global batch; the first step's gradients, gathered over the
  model ranks, within 1e-5 x max|g| + 1e-7 of world 1's; the parameters
  after 3 steps within atol 1e-6 but for elements whose gradient sits at
  the float noise floor (as ``tests/test_torch_ddp.py`` holds them); with
  ``use_fused_adam`` as well (every rank routes the same leaves);
- with dropout on, the losses of ``model=2`` within rtol 1e-5 of world 1
  with the same generator: the masks of the replicated activations are
  drawn alike on both ranks, and those of a rank's heads and hidden columns
  are its slice of the whole layer's;
- the first step's losses against the JAX package's step with
  ``state_shardings(..., tensor_parallel=True)`` on a (data=2, model=2)
  mesh of the fake CPU devices (``tests/test_train.py:224``'s setup,
  ``tests/test_pallas_spmd.py:73``'s rtol 2e-4);
- the rule table (``split_dim``) against ``param_pspec`` for every leaf of
  ``default_config()``, and each split weight's local shape against the
  shard shape of JAX's sharding at model=2;
- a port TP checkpoint (``snapshot_local_shards`` at ``data=2, model=2``):
  each shard file a proper subset, every element written once, loaded by
  the JAX ``load_state_sharded`` and by the port at world 1 to the gathered
  state bit for bit; a JAX TP checkpoint (the layout of
  ``tests/test_checkpoint_sharded.py``'s ``tp_state``) loaded into the
  port's ``model=2`` ranks gives each rank its slices bit for bit;
- ``shard_model_`` keeps a pair whole when its heads (or hidden width) do
  not divide by the model axis, and the incremental path refuses a split
  layer.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch.config import default_config, \
    small_test_config
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.parallel import mesh as mesh_lib
from few_shot_transformer_tts_torch.parallel.sharding_rules import (
    shard_model_, split_dim, take)
from few_shot_transformer_tts_torch.train import checkpoint as ckpt_lib
from few_shot_transformer_tts_torch.train.converter import (
    _jax_leaf, jax_variables_from_state_dict, state_dict_from_jax_variables)
from few_shot_transformer_tts_torch.train.loop import (
    device_batch, make_optimizer, parallel_step_model, step_generator,
    train_step)

from test_torch_ddp import global_batch, local_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
STEPS = 3
NO_DROPOUT = dict(transformer_dropout_rate=0.0, decoder_dropout_rate=0.0)
# (world, model axis) -> cases run by those ranks
CASES = {(2, 2): {"adam": NO_DROPOUT,
                  "fused_adam": dict(NO_DROPOUT, use_fused_adam=True),
                  "dropout": {}},
         (4, 2): {"adam": NO_DROPOUT}}


def tp_steps(hp, batch, grid):
    """``STEPS`` steps of the seed's weights split over ``grid``: losses,
    first-step gradients, the final state dict, Adam moments and each
    split parameter's (dim, ranges, whole shape)."""
    model = init_weights_(ByteToMel(hp, device="cpu"), SEED)
    whole = shard_model_(model, grid.model_rank, grid.model, grid.model_group)
    optimizer, scheduler = make_optimizer(model, hp)
    step_model = parallel_step_model(model, grid, "cpu")
    dbatch = device_batch(batch, hp, "cpu")
    losses, grads = [], None
    for step in range(STEPS):
        out = train_step(step_model, optimizer, scheduler, dbatch, hp,
                         step_generator(SEED, step, "cpu", grid.data_rank),
                         grid.stats_group)
        losses.append(float(out["loss"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    specs = {n: (p.tp.dim, [(r.start, r.stop) for r in p.tp.ranges],
                 p.tp.full_shape)
             for n, p in model.named_parameters() if hasattr(p, "tp")}
    moments = {n: (optimizer.state[p]["exp_avg"].clone(),
                   optimizer.state[p]["exp_avg_sq"].clone())
               for n, p in model.named_parameters()}
    return model, optimizer, {
        "losses": losses, "grads": grads, "state": model.state_dict(),
        "moments": moments, "specs": specs, "whole": whole}


def worker(world, model_axis, rank, port, out_dir, jax_ckpt):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:%d" % port, rank=rank,
        world_size=world)
    grid = mesh_lib.make_grid(model_axis)
    tag = "w%dm%d" % (world, model_axis)
    for case, overrides in CASES[(world, model_axis)].items():
        hp = small_test_config(**overrides)
        batch = global_batch(hp)
        if grid.data > 1:
            batch = local_rows(batch, grid.data_rank)
        model, optimizer, res = tp_steps(hp, batch, grid)
        if case == "adam":
            shards = ckpt_lib.snapshot_local_shards(model, optimizer, STEPS,
                                                    rank, world, grid)
            ckpt_lib.save_state_sharded(os.path.join(out_dir, tag), shards,
                                        STEPS, rank, world)
        res["grid"] = (grid.data, grid.model, grid.data_rank, grid.model_rank)
        torch.save(res, os.path.join(out_dir, "%s-%s-%d.pt"
                                     % (tag, case, rank)))
    if jax_ckpt != "-":
        hp = small_test_config()
        model = ByteToMel(hp, device="cpu")
        shard_model_(model, grid.model_rank, grid.model, grid.model_group)
        optimizer, scheduler = make_optimizer(model, hp)
        step = ckpt_lib.load_state(jax_ckpt, model, optimizer, scheduler)
        torch.save({"step": step, "state": model.state_dict(),
                    "optim": optimizer.state_dict()},
                   os.path.join(out_dir, "%s-jaxload-%d.pt" % (tag, rank)))
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world, model_axis, out_dir, jax_ckpt="-"):
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    return [subprocess.Popen(
        [sys.executable, __file__, str(world), str(model_axis), str(rank),
         str(port), str(out_dir), str(jax_ckpt)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]


def jax_state(hp_overrides, variables):
    """A JAX train state holding ``variables`` (fresh Adam moments)."""
    from few_shot_transformer_tts_tpu.config import small_test_config as jc
    from few_shot_transformer_tts_tpu.models import ByteToMel as JaxModel
    from few_shot_transformer_tts_tpu.train.loop import (
        create_state, device_batch as jax_device_batch)
    hp = jc(**hp_overrides)
    model = JaxModel(hp)
    state = create_state(model, hp, 0, jax_device_batch(global_batch(hp)))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    return model, hp, state


@pytest.fixture(scope="module")
def jax_tp_checkpoint(tmp_path_factory):
    """A JAX TP checkpoint, ``tp_state``'s layout (data=4, model=2), of
    weights from another seed: (its directory, the weights as a port state
    dict)."""
    import jax
    from few_shot_transformer_tts_tpu.parallel import make_mesh
    from few_shot_transformer_tts_tpu.parallel.sharding_rules import \
        state_shardings
    from few_shot_transformer_tts_tpu.train import checkpoint as jax_ckpt
    port = init_weights_(ByteToMel(small_test_config(), device="cpu"),
                         SEED + 1)
    _, _, state = jax_state({}, jax_variables_from_state_dict(
        port.state_dict()))
    state = state.replace(step=np.int32(3))
    mesh = make_mesh(data=4, model=2)
    state = jax.device_put(state, state_shardings(state, mesh,
                                                  tensor_parallel=True))
    path = jax_ckpt.save_state_sharded(
        str(tmp_path_factory.mktemp("jaxtp")), state, 3)
    return path, port.state_dict()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_tp_checkpoint):
    """{(world, model): {case: [each rank's results]}}, plus the JAX
    checkpoint as the model=2 ranks loaded it, and the run's directory."""
    out = tmp_path_factory.mktemp("tp")
    procs = spawn(2, 2, out, jax_tp_checkpoint[0]) + spawn(4, 2, out)
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = {}
    for (world, model_axis), cases in CASES.items():
        tag = "w%dm%d" % (world, model_axis)
        got[(world, model_axis)] = {
            case: [torch.load(out / ("%s-%s-%d.pt" % (tag, case, r)),
                              weights_only=False) for r in range(world)]
            for case in cases}
    got["jaxload"] = [torch.load(out / ("w2m2-jaxload-%d.pt" % r),
                                 weights_only=False) for r in range(2)]
    got["dir"] = out
    return got


def world1(overrides):
    """The port's one-process run over the global batch."""
    hp = small_test_config(**overrides)
    model = init_weights_(ByteToMel(hp, device="cpu"), SEED)
    optimizer, scheduler = make_optimizer(model, hp)
    dbatch = device_batch(global_batch(hp), hp, "cpu")
    losses, grads = [], None
    for step in range(STEPS):
        out = train_step(model, optimizer, scheduler, dbatch, hp,
                         step_generator(SEED, step, "cpu"))
        losses.append(float(out["loss"]))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads, "state": model.state_dict(),
            "first": {k: float(v) for k, v in out.items()
                      if k != "lr" and v.dim() == 0}}


def gather(results, key, name):
    """The whole tensor of ``results[*][key][name]`` from the model ranks of
    data index 0 (each rank's parts put back at their ranges)."""
    ranks = [r for r in results if r["grid"][2] == 0]
    ranks.sort(key=lambda r: r["grid"][3])
    local = lambda r: r[key][name] if key != "moments" else r[key][name][0]
    spec = ranks[0]["specs"].get(name)
    if spec is None:
        return local(ranks[0])
    dim, _, full_shape = spec
    out = torch.zeros(full_shape)
    for r in ranks:
        at = 0
        for start, stop in r["specs"][name][1]:
            index = [slice(None)] * len(full_shape)
            index[dim] = slice(start, stop)
            out[tuple(index)] = local(r).narrow(dim, at, stop - start)
            at += stop - start
    return out


@pytest.mark.parametrize("grid, case", [((2, 2), "adam"),
                                        ((2, 2), "fused_adam"),
                                        ((4, 2), "adam")])
def test_tensor_parallel_steps_match_world_one(ranks, grid, case):
    results = ranks[grid][case]
    want = world1(CASES[grid][case])
    for r in results:
        assert r["losses"] == results[0]["losses"]
        assert r["whole"] == []
    np.testing.assert_allclose(results[0]["losses"], want["losses"],
                               rtol=1e-5)
    assert results[0]["specs"], "no weight was split"
    held = 0
    for name, g in want["grads"].items():
        got = gather(results, "grads", name)
        bound = 1e-5 * float(g.abs().max()) + 1e-7
        assert float((got - g).abs().max()) <= bound, name
    for name, value in want["state"].items():
        g = want["grads"].get(name)
        conditioned = g.abs() >= 1e-5 * g.abs().max() if g is not None \
            else torch.ones_like(value, dtype=torch.bool)
        held += int(conditioned.sum())
        got = gather(results, "state", name)
        if value.is_floating_point():
            err = float((got - value)[conditioned].abs().max()) \
                if conditioned.any() else 0.0
            assert err <= 1e-6, (name, err)
        else:
            assert torch.equal(got, value), name
    assert held >= 0.9 * sum(v.numel() for v in want["state"].values())


def test_tensor_parallel_dropout_draws_the_whole_layers_masks(ranks):
    results = ranks[(2, 2)]["dropout"]
    want = world1({})
    assert results[0]["losses"] == results[1]["losses"]
    np.testing.assert_allclose(results[0]["losses"], want["losses"],
                               rtol=1e-5)


def test_first_step_matches_the_jax_state_shardings_step(ranks):
    import jax
    from few_shot_transformer_tts_tpu.parallel import make_mesh
    from few_shot_transformer_tts_tpu.parallel.mesh import (
        pad_batch_to_devices, shard_batch)
    from few_shot_transformer_tts_tpu.parallel.sharding_rules import \
        state_shardings
    from few_shot_transformer_tts_tpu.train.loop import (
        device_batch as jax_device_batch, make_train_step)
    hp = small_test_config(**NO_DROPOUT)
    port = init_weights_(ByteToMel(hp, device="cpu"), SEED)
    model, jhp, state = jax_state(NO_DROPOUT, jax_variables_from_state_dict(
        port.state_dict()))
    batch = global_batch(hp)
    batch["mel_targets"] = device_batch(batch, hp, "cpu")[
        "mel_targets"].numpy()
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    st_shard = state_shardings(state, mesh, tensor_parallel=True)
    assert len({s.spec for s in jax.tree.leaves(st_shard)}) > 1
    step = make_train_step(model, jhp, mesh=mesh, donate=False,
                           state_sharding=st_shard)
    _, losses = step(state, shard_batch(pad_batch_to_devices(
        jax_device_batch(batch), 2), mesh), jax.random.PRNGKey(0))
    for grid in ((2, 2), (4, 2)):
        got = ranks[grid]["adam"][0]["losses"][0]
        np.testing.assert_allclose(got, float(losses["loss"]), rtol=2e-4)


def test_rule_table_matches_param_pspec_on_every_flagship_leaf():
    import jax
    from few_shot_transformer_tts_tpu.parallel import make_mesh
    from few_shot_transformer_tts_tpu.parallel.sharding_rules import (
        param_pspec, state_shardings)
    hp = default_config()
    model = ByteToMel(hp, device="cpu")
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shard_model_(model, 1, 2, None) == []
    paths, tree = {}, {}
    for name, p in model.named_parameters():
        kind, path = _jax_leaf(name)
        paths[name] = path
        shape = whole[name][::-1] if kind in ("kernel", "conv_kernel") \
            else whole[name]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.broadcast_to(np.float32(0), shape)
    mesh = make_mesh(data=4, model=2)
    shardings = state_shardings({"params": tree}, mesh, tensor_parallel=True)
    split = 0
    for name, p in model.named_parameters():
        spec = param_pspec(("params",) + paths[name])
        want = spec.index("model") if "model" in spec else None
        assert split_dim(paths[name]) == want, name
        node = shardings["params"]
        for key in paths[name]:
            node = node[key]
        kind = _jax_leaf(name)[0]
        jax_whole = whole[name][::-1] if kind == "kernel" else whole[name]
        local = tuple(p.shape)[::-1] if kind == "kernel" else tuple(p.shape)
        if kind == "conv_kernel":
            continue
        assert local == tuple(node.shard_shape(jax_whole)), name
        split += want is not None
    # each encoder layer: qkv, out and the FFN pair; each decoder layer:
    # those and the cross-attention's q, kv and out
    assert split == hp.n_encoder_layer * 4 + hp.n_decoder_layer * 7


def test_tp_checkpoint_files_cover_each_element_once(ranks):
    ckpt = ranks["dir"] / "w4m2" / ("model.ckpt-%d.d" % STEPS)
    names = sorted(os.listdir(ckpt))
    assert names == ["shard-%d-of-4.pkl" % r for r in range(4)]
    payloads = [pickle.load(open(ckpt / n, "rb"))["leaves"] for n in names]
    union = set().union(*payloads)
    covered = {}
    split_pieces = 0
    for leaves in payloads:
        assert 0 < len(leaves) < len(union)
        for key, rec in leaves.items():
            cov = covered.setdefault(key, np.zeros(rec["shape"], np.int64))
            for index, data in rec["shards"]:
                cov[tuple(index)] += 1
                assert np.asarray(data).shape == cov[tuple(index)].shape
                split_pieces += np.asarray(data).size < cov.size
    assert all(np.all(c == 1) for c in covered.values())
    assert split_pieces > 0


def test_tp_checkpoint_loads_in_jax_and_at_world_one(ranks):
    from few_shot_transformer_tts_tpu.train import checkpoint as jax_ckpt
    results = ranks[(4, 2)]["adam"]
    ckpt = str(ranks["dir"] / "w4m2" / ("model.ckpt-%d.d" % STEPS))
    want = {n: gather(results, "state", n) for n in results[0]["state"]}
    # the JAX package's loader
    _, _, template = jax_state({}, jax_variables_from_state_dict(
        ByteToMel(small_test_config(), device="cpu").state_dict()))
    state = jax_ckpt.load_state_sharded(ckpt, template)
    assert int(state.step) == STEPS
    got = state_dict_from_jax_variables({
        "params": state.params, "batch_stats": state.batch_stats})
    for name, value in got.items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(value, want[name]), name
    # the port at world 1, Adam moments included
    hp = small_test_config(**NO_DROPOUT)
    model = ByteToMel(hp, device="cpu")
    optimizer, scheduler = make_optimizer(model, hp)
    assert ckpt_lib.load_state(ckpt, model, optimizer, scheduler) == STEPS
    for name, value in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(value, want[name]), name
    for name, p in model.named_parameters():
        assert torch.equal(optimizer.state[p]["exp_avg"],
                           gather(results, "moments", name)), name


def test_jax_tp_checkpoint_loads_into_the_ports_tp_ranks(ranks,
                                                         jax_tp_checkpoint):
    _, whole = jax_tp_checkpoint
    for m, loaded in enumerate(ranks["jaxload"]):
        model = ByteToMel(small_test_config(), device="cpu")
        shard_model_(model, m, 2, None)
        params = dict(model.named_parameters())
        assert loaded["step"] == 3
        for name, value in loaded["state"].items():
            if name.endswith("num_batches_tracked"):
                continue
            spec = getattr(params.get(name), "tp", None)
            want = whole[name] if spec is None else take(whole[name], spec)
            assert torch.equal(value, want), name
            assert spec is None or value.shape != whole[name].shape


def test_shard_model_keeps_indivisible_pairs_whole():
    hp = small_test_config()
    model = ByteToMel(hp, device="cpu")
    whole = shard_model_(model, 0, 3, None)
    # 4 heads do not split 3 ways; the encoder FFN (128 wide) does not, the
    # decoder FFN (192 wide) does
    assert {n.rsplit(".", 2)[-2] for n in whole} == {
        "self_attentions", "encdec_attentions", "ffn_layers"}
    assert not any(n.startswith("decoder") and "ffn" in n for n in whole)
    dec = model.decoder.decoder.ffn_layers[0]
    assert dec.input_layer.weight.shape[0] == 64 and dec.hidden_offset == 0
    assert model.encoder.encoder.self_attentions[0].local_heads == 4
    split = ByteToMel(hp, device="cpu")
    shard_model_(split, 1, 2, None)
    with pytest.raises(ValueError, match="whole layers"):
        split.decoder.decoder.encdec_attentions[0].project_kv(
            torch.zeros(1, 3, 48))


def test_kernel_mask_of_a_ranks_heads_is_the_layers_slice():
    """The attention kernels' mask (their plain version) with a head offset
    is the whole layer's mask of those heads, and so is the output of the
    rank's heads."""
    from few_shot_transformer_tts_torch.ops import mha as mha_ops
    seed = torch.tensor([123456789], dtype=torch.int64)
    full = mha_ops.dropout_keep_mask(seed, 2, 8, 24, 40, 0.1)
    for offset in (0, 4):
        part = mha_ops.dropout_keep_mask(seed, 2, 4, 24, 40, 0.1, offset)
        assert torch.equal(part, full[:, offset:offset + 4])
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(2, 24, 8 * 16).astype(np.float32))
               for _ in range(3))
    o, lse = mha_ops.mha_forward(q, k, v, None, 8, True, 0.25, False, 0.1,
                                 seed)
    cols = slice(4 * 16, 8 * 16)
    o4, lse4 = mha_ops.mha_forward(q[..., cols], k[..., cols], v[..., cols],
                                   None, 4, True, 0.25, False, 0.1, seed, 4)
    assert torch.equal(o4, o[..., cols]) and torch.equal(lse4, lse[..., 4:])
    do = torch.from_numpy(rng.randn(2, 24, 8 * 16).astype(np.float32))
    grads = mha_ops.mha_backward(q, k, v, None, seed, o, lse, do, 8, True,
                                 0.25, False, 0.1)
    grads4 = mha_ops.mha_backward(q[..., cols], k[..., cols], v[..., cols],
                                  None, seed, o4, lse4, do[..., cols], 4,
                                  True, 0.25, False, 0.1, 4)
    for g, g4 in zip(grads, grads4):
        assert torch.equal(g4, g[..., cols])


@pytest.mark.parametrize("world, model, match", [
    (4, 3, "mesh_model_axis=3 does not divide"), (2, 0, "does not divide")])
def test_make_grid_rejects(world, model, match, monkeypatch):
    monkeypatch.setattr(mesh_lib, "process_count", lambda: world)
    with pytest.raises(ValueError, match=match):
        mesh_lib.make_grid(model)


def test_grid_of_one_process():
    grid = mesh_lib.make_grid(1)
    assert (grid.data, grid.model, grid.data_rank, grid.model_rank) == \
        (1, 1, 0, 0)
    assert grid.model_group is grid.data_group is grid.stats_group is None


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5], sys.argv[6])
