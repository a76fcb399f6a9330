"""Data-parallel training of the port (``parallel/mesh.py``, DDP over gloo on
the CPU, fp32, small_test_config) against the one-process step over the
same global batch.

Two worker processes (this file run as a script) each take their own rows of
one 8-row global batch, split 3/5 and cropped to each rank's own padded
shape, and train 3 Adam steps under ``DistributedDataParallel`` with the
loss and BatchNorm all-reduces, as the train CLI builds them
(``make_grid(1)``'s groups, ``parallel_step_model``):

- at dropout 0, with ``torch.optim.Adam`` and with ``use_fused_adam``: the
  losses of both ranks are equal and within rtol 1e-5 of the port's
  one-process run over the global batch, each step's DDP-averaged gradients
  within 1e-5 x max|g| of its gradients, and the BatchNorm running
  statistics and the parameters after 3 steps within atol 1e-6 of it.  A
  parameter element whose gradient sits at the float noise floor (below
  1e-5 of its leaf's largest: the speaker and language channels of the
  attention key projections, constant over time, get a gradient that is
  zero in exact arithmetic) is held through its gradient alone: Adam's
  lr * g / (|g| + eps) turns two noise values of opposite sign (-2.2e-9
  and 1.5e-9 against a largest gradient of 1.0) into updates ~1e-4
  apart;
- the first step's loss and DDP-averaged gradients against ``jax.grad`` of
  the JAX package's loss over the global batch, weights carried through the
  bridge: rtol 1e-5 on the losses, 1e-5 x max|g| (+1e-7) per leaf;
- with dropout on, the ranks draw different masks and the losses are
  finite and equal on both ranks;
- ``check_mesh`` rejects a ``mesh_data_axis`` other than -1 or the world
  size and a ``mesh_model_axis`` that does not divide it; ``init_distributed``
  raises without torchrun's environment, and one process has no group.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.ops.mha import draw_seed
from few_shot_transformer_tts_torch.parallel import mesh as mesh_lib
from few_shot_transformer_tts_torch.train.loop import (
    device_batch, make_optimizer, parallel_step_model, step_generator,
    train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
ROWS = (3, 5)            # rows of the global batch per rank
SEED = 5
STEPS = 3
NO_DROPOUT = dict(transformer_dropout_rate=0.0, decoder_dropout_rate=0.0)
CASES = {"adam": NO_DROPOUT,
         "fused_adam": dict(NO_DROPOUT, use_fused_adam=True),
         "dropout": {}}


def global_batch(hp, b=8, t_in=40, t_out=64, seed=0):
    """A lattice-padded global batch, zero beyond each row's lengths; the
    longest input is in the first rank's rows and the longest target in the
    second's, so each rank crops to its own shape."""
    rng = np.random.RandomState(seed)
    il = rng.randint(t_in // 2, t_in - 7, b).astype(np.int32)
    tl = rng.randint(t_out // 2, t_out - 7, b).astype(np.int32)
    il[0], tl[-1] = t_in, t_out
    inputs = rng.randint(3, 255, (b, t_in)).astype(np.int32)
    mel = np.clip(rng.randn(b, t_out, hp.num_mels), -4, 4).astype(np.float32)
    for i in range(b):
        inputs[i, il[i]:] = 0
        mel[i, tl[i]:] = 0
    return dict(
        inputs=inputs, input_lengths=il, mel_targets=mel, target_lengths=tl,
        input_spk_ids=rng.randint(0, hp.max_num_speaker, b).astype(np.int32),
        input_language_vecs=np.eye(hp.max_num_language, dtype=np.float32)[
            rng.randint(0, hp.max_num_language, b)])


def local_rows(batch, rank):
    """This rank's rows, cropped to its own padded shape (lengths rounded
    up to 8), as a Feeder packing only these rows would emit them."""
    start = sum(ROWS[:rank])
    local = {k: v[start:start + ROWS[rank]] for k, v in batch.items()}
    t_in = min(-(-int(local["input_lengths"].max()) // 8) * 8,
               local["inputs"].shape[1])
    t_out = min(-(-int(local["target_lengths"].max()) // 8) * 8,
                local["mel_targets"].shape[1])
    local["inputs"] = local["inputs"][:, :t_in]
    local["mel_targets"] = local["mel_targets"][:, :t_out]
    return {k: np.ascontiguousarray(v) for k, v in local.items()}


def run_steps(hp, batch, rank=0, grid=None):
    """``STEPS`` train steps from the seed's weights: the global losses,
    each step's gradients, the final state dict and the first step's
    generator draws.  ``grid``: the data-parallel grid of the rank, else
    one process."""
    model = init_weights_(ByteToMel(hp, device="cpu"), SEED)
    optimizer, scheduler = make_optimizer(model, hp)
    step_model = parallel_step_model(model, grid, "cpu") if grid else model
    group = grid.stats_group if grid else None
    dbatch = device_batch(batch, hp, "cpu")
    losses, grads = [], []
    for step in range(STEPS):
        out = train_step(step_model, optimizer, scheduler, dbatch, hp,
                         step_generator(SEED, step, "cpu", rank), group)
        losses.append(float(out["loss"]))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    gen = step_generator(SEED, 0, "cpu", rank)
    draws = torch.cat([torch.rand(16, generator=gen),
                       draw_seed(gen, "cpu").double().reshape(1)])
    return {"losses": losses, "grads": grads, "state": model.state_dict(),
            "draws": draws}


def worker(rank, port, out_dir):
    torch.set_num_threads(2)
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:%d" % port, rank=rank,
        world_size=WORLD)
    grid = mesh_lib.make_grid(1)
    for case, overrides in CASES.items():
        hp = small_test_config(**overrides)
        batch = local_rows(global_batch(hp), rank)
        torch.save(run_steps(hp, batch, rank, grid),
                   os.path.join(out_dir, "%s-%d.pt" % (case, rank)))
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: [rank 0's results, rank 1's]} of one two-process run."""
    out = tmp_path_factory.mktemp("ddp")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(port), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {case: [torch.load(out / ("%s-%d.pt" % (case, r)),
                              weights_only=True) for r in range(WORLD)]
            for case in CASES}


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process run over the global batch, per case."""
    return {case: run_steps(small_test_config(**o),
                            global_batch(small_test_config(**o)))
            for case, o in CASES.items()}


def test_local_rows_are_uneven_and_cropped():
    hp = small_test_config()
    full = global_batch(hp)
    shapes = [local_rows(full, r)["mel_targets"].shape for r in range(WORLD)]
    assert [s[0] for s in shapes] == list(ROWS)
    assert shapes[0][1] < full["mel_targets"].shape[1] == shapes[1][1]
    assert local_rows(full, 0)["inputs"].shape[1] == full["inputs"].shape[1]
    assert local_rows(full, 1)["inputs"].shape[1] < full["inputs"].shape[1]


@pytest.mark.parametrize("case", ["adam", "fused_adam"])
def test_two_ranks_match_one_process(ranks, one_process, case):
    r0, r1 = ranks[case]
    want = one_process[case]
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=1e-5)
    assert r0["losses"][-1] < r0["losses"][0]
    assert sorted(r0["state"]) == sorted(want["state"])
    for name, g in want["grads"][0].items():
        bound = 1e-5 * float(g.abs().max()) + 1e-7
        for r in (r0, r1):
            err = float((r["grads"][0][name] - g).abs().max())
            assert err <= bound, (name, err, bound)
    held = 0
    for name, value in want["state"].items():
        g = want["grads"][0].get(name)
        conditioned = g.abs() >= 1e-5 * g.abs().max() if g is not None \
            else torch.ones_like(value, dtype=torch.bool)
        held += int(conditioned.sum())
        for r in (r0, r1):
            got = r["state"][name]
            if value.is_floating_point():
                err = float((got - value)[conditioned].abs().max()) \
                    if conditioned.any() else 0.0
                assert err <= 1e-6, (name, err)
            else:
                assert torch.equal(got, value), name
    # the noise floor is a small share of the elements
    assert held >= 0.9 * sum(v.numel() for v in want["state"].values())
    # the running statistics were updated, and the same way on each rank
    stats = [n for n in want["state"] if n.endswith("running_var")]
    assert stats and all(torch.equal(r0["state"][n], r1["state"][n])
                         for n in stats)


@pytest.mark.parametrize("case", ["adam", "fused_adam"])
def test_first_step_matches_jax_over_the_global_batch(ranks, case):
    import jax
    from few_shot_transformer_tts_tpu.config import small_test_config \
        as jax_cfg
    from few_shot_transformer_tts_torch.train.converter import (
        jax_variables_from_state_dict, state_dict_from_jax_variables)
    from test_torch_train import _jax_grads
    overrides = CASES[case]
    hp = small_test_config(**overrides)
    variables = jax_variables_from_state_dict(
        init_weights_(ByteToMel(hp, device="cpu"), SEED).state_dict())
    batch = global_batch(hp)
    # the mels the port trained on: through the int16 wire of device_batch
    batch["mel_targets"] = device_batch(batch, hp, "cpu")[
        "mel_targets"].numpy()
    grads, want_losses, _ = _jax_grads(variables, batch,
                                       jax_cfg(**NO_DROPOUT))
    r0, r1 = ranks[case]
    np.testing.assert_allclose(r0["losses"][0], float(want_losses["loss"]),
                               rtol=1e-5)
    want = state_dict_from_jax_variables(
        {"params": jax.tree.map(np.asarray, grads)})
    assert sorted(want) == sorted(r0["grads"][0])
    for name, g_want in want.items():
        bound = 1e-5 * float(g_want.abs().max()) + 1e-7
        for r in (r0, r1):
            err = float((r["grads"][0][name] - g_want).abs().max())
            assert err <= bound, (name, err, bound)


def test_dropout_draws_differ_between_ranks(ranks):
    r0, r1 = ranks["dropout"]
    assert np.all(np.isfinite(r0["losses"]))
    assert r0["losses"] == r1["losses"]
    assert not torch.equal(r0["draws"], r1["draws"])
    # rank 0 keeps the one-process stream
    gen = step_generator(SEED, 0, "cpu")
    assert torch.equal(r0["draws"][:16], torch.rand(16, generator=gen))


@pytest.mark.parametrize("overrides, world, match", [
    (dict(mesh_data_axis=3), 2, "mesh_data_axis=3"),
    (dict(mesh_model_axis=3), 2, "mesh_model_axis=3 does not divide"),
    (dict(mesh_model_axis=0), 1, "mesh_model_axis"),
])
def test_check_mesh_rejects(overrides, world, match):
    with pytest.raises(ValueError, match=match):
        mesh_lib.check_mesh(small_test_config(**overrides), world)


@pytest.mark.parametrize("data_axis", [-1, 2])
def test_check_mesh_accepts(data_axis):
    mesh_lib.check_mesh(small_test_config(mesh_data_axis=data_axis), 2)


def test_init_distributed_needs_torchruns_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.init_distributed("gloo", "cpu")
    assert mesh_lib.process_count() == 1 and mesh_lib.process_index() == 0
    assert mesh_lib.make_grid(1) == mesh_lib.Grid(1, 1, 0, 0)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
