"""The port's training step against the JAX package's, fp32 at
small_test_config with the same weights.

- ``compute_loss``, ``l2_loss``, ``learning_rate_schedule`` and the masked
  ``MaskedBatchNorm`` batch statistics (output and running statistics):
  within 1e-6.
- The gradients of one step at dropout 0 against ``jax.grad`` of the JAX
  loss, leaf by leaf: |g - g_jax| <= 1e-5 * max|g_jax| + 1e-7.  The
  Adam-updated parameters are not compared after a step: lr*g/(|g|+eps)
  turns float noise in tiny gradients into sign flips of size 2*lr.
- Adam and the LR schedule alone, fed the same gradients for 3 steps,
  against optax ``make_optimizer``: parameters within 1e-6, from zero
  moments and from moments carried over by ``optimizer_state_from_jax``.
- Lattice-padding rows leave every loss term unchanged, and two runs of 3
  steps with dropout on and one seed give identical losses.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.models import ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.models import tacotron as jax_tacotron
from few_shot_transformer_tts_tpu.train import loop as jax_loop
from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.models.tacotron import (
    MaskedBatchNorm, compute_loss, l2_loss, learning_rate_schedule)
from few_shot_transformer_tts_torch.train.converter import (
    optimizer_state_from_jax, state_dict_from_jax_variables)
from few_shot_transformer_tts_torch.train.loop import (
    dequantize_wire_mels, device_batch, make_optimizer, quantize_wire_mels,
    step_generator, train_step)

from test_torch_weights import jax_variables, port_model

NO_DROPOUT = dict(transformer_dropout_rate=0.0, decoder_dropout_rate=0.0)


def make_batch(hp, b=4, t_in=12, t_out=16, seed=0):
    """A padded numpy batch: ragged lengths, mels zero beyond them."""
    rng = np.random.RandomState(seed)
    tl = rng.randint(t_out // 2, t_out + 1, b).astype(np.int32)
    il = rng.randint(t_in // 2, t_in + 1, b).astype(np.int32)
    tl[0], il[0] = t_out, t_in
    mel = np.clip(rng.randn(b, t_out, hp.num_mels), -4, 4).astype(np.float32)
    mel[np.arange(t_out)[None, :] >= tl[:, None]] = 0.0
    return dict(
        inputs=rng.randint(3, 255, (b, t_in)).astype(np.int32),
        input_lengths=il, mel_targets=mel, target_lengths=tl,
        input_spk_ids=rng.randint(0, 4, b).astype(np.int32),
        input_language_vecs=np.eye(hp.max_num_language, dtype=np.float32)[
            rng.randint(0, 3, b)])


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_compute_loss_and_l2_match_jax():
    hp = small_test_config()
    variables = jax_variables(2)
    model = port_model(variables)
    rng = np.random.RandomState(3)
    b, t = 3, 9
    lengths = np.asarray([9, 5, 0], np.int32)     # a lattice-padding row
    targets = rng.randn(b, t, hp.num_mels).astype(np.float32)
    outputs = {k: rng.randn(*s).astype(np.float32) for k, s in [
        ("mel_bef", (b, t, hp.num_mels)), ("mel_aft", (b, t, hp.num_mels)),
        ("stop_logits", (b, t))]}
    want = jax_tacotron.compute_loss(
        variables["params"], jnp.asarray(targets), jnp.asarray(lengths),
        {k: jnp.asarray(v) for k, v in outputs.items()}, jax_cfg())
    got = compute_loss(model, torch.from_numpy(targets),
                       torch.from_numpy(lengths),
                       {k: torch.from_numpy(v) for k, v in outputs.items()},
                       hp)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(
        l2_loss(model).item(),
        float(jax_tacotron.l2_loss(variables["params"])), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 49999, 50000, 50001, 10 ** 6])
def test_learning_rate_schedule_matches_jax(step):
    want = float(jax_tacotron.learning_rate_schedule(jnp.asarray(step),
                                                     jax_cfg()))
    got = learning_rate_schedule(step, small_test_config())
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_masked_batchnorm_matches_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 7, 5) * 2 + 1).astype(np.float32)
    lengths = np.asarray([7, 3, 0], np.int32)
    mean0 = (0.1 * rng.randn(5)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(5)).astype(np.float32)
    bias = (0.1 * rng.randn(5)).astype(np.float32)
    jbn = jax_tacotron.MaskedBatchNorm(5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, muts = jbn.apply(variables, jnp.asarray(x), jnp.asarray(lengths),
                           use_running_average=False,
                           mutable=["batch_stats"])
    bn = MaskedBatchNorm(5, torch.float32)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = bn(torch.from_numpy(x), torch.from_numpy(lengths),
             use_running_average=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(muts["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(muts["batch_stats"]["var"]),
                               atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    # eval: the running statistics
    want_eval = jbn.apply({"params": variables["params"],
                           "batch_stats": muts["batch_stats"]},
                          jnp.asarray(x), jnp.asarray(lengths),
                          use_running_average=True)
    np.testing.assert_allclose(
        bn(torch.from_numpy(x), torch.from_numpy(lengths)).detach().numpy(),
        np.asarray(want_eval), atol=1e-6)


def _jax_grads(variables, batch, hp):
    """jax.grad of the JAX train step's loss_fn (train/loop.py:216-223)."""
    model = JaxByteToMel(hp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        outputs, muts = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"], **jbatch)
        losses = jax_tacotron.compute_loss(
            params, jbatch["mel_targets"], jbatch["target_lengths"],
            outputs, hp)
        return losses["loss"], (losses, muts)

    grads, (losses, muts) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"])
    return jax.tree.map(np.asarray, grads), losses, muts


def test_one_step_gradients_match_jax_grad():
    variables = jax_variables(5, **NO_DROPOUT)
    hp = small_test_config(**NO_DROPOUT)
    batch = make_batch(hp, seed=5)
    grads, want_losses, muts = _jax_grads(variables, batch, jax_cfg(
        **NO_DROPOUT))

    model = port_model(variables, **NO_DROPOUT).train()
    tb = _torch(batch)
    out = model(tb["inputs"], tb["input_lengths"], tb["mel_targets"],
                tb["target_lengths"], tb["input_spk_ids"],
                tb["input_language_vecs"], train=True)
    losses = compute_loss(model, tb["mel_targets"], tb["target_lengths"],
                          out, hp)
    losses["loss"].backward()
    for key in ("loss", "bef_loss", "aft_loss", "stop_loss", "l2"):
        np.testing.assert_allclose(losses[key].item(),
                                   float(want_losses[key]), rtol=1e-5,
                                   err_msg=key)
    want = state_dict_from_jax_variables({"params": grads})
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g_want in want.items():
        g = got[name].grad
        assert g is not None, name
        bound = 1e-5 * float(g_want.abs().max()) + 1e-7
        err = float((g - g_want).abs().max())
        assert err <= bound, (name, err, bound)
    # the running statistics the step leaves behind
    stats = state_dict_from_jax_variables(
        {"params": {}, "batch_stats": jax.tree.map(np.asarray,
                                                   muts["batch_stats"])})
    buffers = dict(model.named_buffers())
    for name, want_stat in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[name].numpy(),
                                       want_stat.numpy(), atol=1e-6,
                                       err_msg=name)


def _random_grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: np.asarray(rng.randn(*np.shape(p)), np.float32), params)


@pytest.mark.parametrize("carried", [False, True],
                         ids=["zero_moments", "moments_from_jax"])
def test_adam_and_schedule_match_optax(carried):
    hp_kw = dict(warmup_steps=1, lr_decay_step=4, lr_decay_rate=0.1)
    hp = small_test_config(**hp_kw)
    variables = jax_variables(6)
    params = variables["params"]
    tx = jax_loop.make_optimizer(jax_cfg(**hp_kw))
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    model = port_model(variables)
    start = 0
    if carried:
        for i in range(3):      # the JAX side runs ahead, the port takes over
            params, opt_state = jax_step(_random_grads(params, 100 + i),
                                         opt_state, params)
        model.load_state_dict(state_dict_from_jax_variables(
            {"params": jax.tree.map(np.asarray, params),
             "batch_stats": variables["batch_stats"]}))
        start = 3
    optimizer, scheduler = make_optimizer(model, hp)
    if carried:
        with warnings.catch_warnings():   # no updates yet: torch warns
            warnings.simplefilter("ignore")
            for _ in range(start):
                scheduler.step()
        adam = opt_state[0]
        optimizer.load_state_dict(optimizer_state_from_jax(
            jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu), int(adam.count), model,
            optimizer))
    named = dict(model.named_parameters())
    for i in range(3):
        g = _random_grads(params, i)
        params, opt_state = jax_step(g, opt_state, params)
        for name, t in state_dict_from_jax_variables({"params": g}).items():
            named[name].grad = t
        optimizer.step()
        scheduler.step()
    want = state_dict_from_jax_variables(
        {"params": jax.tree.map(np.asarray, params)})
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert scheduler.last_epoch == start + 3


def test_lattice_padding_rows_do_not_change_loss():
    """At dropout 0 (masks drawn for a padded shape differ), with the
    masked BatchNorm batch statistics of the train mode."""
    hp = small_test_config(**NO_DROPOUT)
    model = port_model(jax_variables(7, **NO_DROPOUT), **NO_DROPOUT).train()
    batch = make_batch(hp, seed=7)
    padded = {k: np.concatenate([v, np.zeros((4,) + v.shape[1:], v.dtype)])
              for k, v in batch.items()}

    def losses(b):
        tb = device_batch(b, hp, "cpu")
        out = model(tb["inputs"], tb["input_lengths"], tb["mel_targets"],
                    tb["target_lengths"], tb["input_spk_ids"],
                    tb["input_language_vecs"], train=True)
        return compute_loss(model, tb["mel_targets"], tb["target_lengths"],
                            out, hp)

    with torch.no_grad():
        l1, l2 = losses(batch), losses(padded)
    for key in ["bef_loss", "aft_loss", "stop_loss", "l2", "loss"]:
        assert l1[key].item() == pytest.approx(l2[key].item(), rel=1e-5), key


def test_training_is_deterministic_under_one_seed():
    hp = small_test_config()
    batch = make_batch(hp, seed=8)

    def run():
        model = port_model(jax_variables(8))
        optimizer, scheduler = make_optimizer(model, hp)
        tb = device_batch(batch, hp, "cpu")
        return [train_step(model, optimizer, scheduler, tb, hp,
                           step_generator(3, step, "cpu"))["loss"].item()
                for step in range(3)]

    first = run()
    assert first == run()
    assert first[-1] < first[0]
    # the generator of a step is a pure function of (seed, step)
    draw = lambda s, t: torch.rand(4, generator=step_generator(s, t, "cpu"))
    assert torch.equal(draw(3, 1), draw(3, 1))
    assert not torch.equal(draw(3, 1), draw(3, 2))
    assert not torch.equal(draw(3, 1), draw(4, 1))


def test_int16_mel_wire_matches_jax():
    hp = small_test_config()
    batch = make_batch(hp, seed=9)
    batch["mel_targets"][0, 0, 0] = 5.0            # clipped on the wire
    q = quantize_wire_mels(batch, hp)
    want = jax_loop.quantize_wire_mels(batch, jax_cfg())
    np.testing.assert_array_equal(q["mel_targets"], want["mel_targets"])
    deq = dequantize_wire_mels(_torch(q), hp)["mel_targets"]
    want_deq = jax_loop.dequantize_wire_mels(
        {"mel_targets": jnp.asarray(want["mel_targets"])}, jax_cfg())
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(want_deq["mel_targets"]))
    err = np.abs(deq.numpy() - batch["mel_targets"])
    assert err[:, 1:].max() <= hp.max_abs_value / 32767.0 + 1e-7
