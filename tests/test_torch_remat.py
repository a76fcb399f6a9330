"""``hp.remat`` in the port (activation checkpointing of every attention and
FFN call of the teacher-forced path, ``models/modules.py:remat_call``),
fp32 at small_test_config on the CPU:

- with dropout on and one generator, a remat step and a plain one give the
  same loss and the same gradients bit for bit, leave the generator in the
  same state, and after 3 Adam steps (``torch.optim.Adam`` and
  ``use_fused_adam``) the same parameters bit for bit;
- ``remat_call`` around ``MhaFunction`` with dropout (the kernel's autograd
  Function; on CPU tensors its plain versions): the recompute draws the
  forward's seed, so the gradients are the plain call's bit for bit, and
  the forward runs twice;
- the port's remat step against ``jax.grad`` of the JAX package's remat step
  (``tests/test_train.py:205``'s setup) at dropout 0: losses within rtol
  1e-5, each gradient leaf within 1e-5 x max|g| + 1e-7 (the bar of
  ``tests/test_torch_train.py``);
- the parameter names and shapes (the state dict) do not change.
"""

import jax
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_torch.config import small_test_config
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.modules import remat_call
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.ops import mha as mha_ops
from few_shot_transformer_tts_torch.train.converter import (
    jax_variables_from_state_dict, state_dict_from_jax_variables)
from few_shot_transformer_tts_torch.train.loop import (
    device_batch, make_optimizer, step_generator, train_step)

from test_torch_train import NO_DROPOUT, _jax_grads, make_batch

SEED = 3


def run(remat, steps=1, **overrides):
    """``steps`` train steps from the seed's weights: (losses, the first
    step's gradients, the final parameters, the generator's state after
    the first step)."""
    hp = small_test_config(remat=remat, **overrides)
    model = init_weights_(ByteToMel(hp, device="cpu"), SEED)
    optimizer, scheduler = make_optimizer(model, hp)
    batch = device_batch(make_batch(hp, b=4, t_in=14, t_out=20, seed=SEED),
                         hp, "cpu")
    losses, grads, gen_state = [], None, None
    for step in range(steps):
        gen = step_generator(SEED, step, "cpu")
        out = train_step(model, optimizer, scheduler, batch, hp, gen)
        losses.append(out["loss"].item())
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            gen_state = gen.get_state()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, grads, params, gen_state


def test_remat_step_is_bit_identical_with_dropout():
    hp = small_test_config()
    assert hp.transformer_dropout_rate > 0 and hp.decoder_dropout_rate > 0
    want = run(False)
    got = run(True)
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for name, g in want[1].items():
        assert torch.equal(got[1][name], g), name
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("fused", [False, True])
def test_remat_adam_steps_are_bit_identical(fused):
    want = run(False, steps=3, use_fused_adam=fused)
    got = run(True, steps=3, use_fused_adam=fused)
    assert got[0] == want[0]
    assert want[0][-1] < want[0][0]
    for name, p in want[2].items():
        assert torch.equal(got[2][name], p), name


def test_remat_call_recomputes_the_attention_functions_forward():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 12, 32).astype(np.float32))
               .requires_grad_() for _ in range(3))

    def attend(q, k, v, generator):
        seed = mha_ops.draw_seed(generator, "cpu")
        return mha_ops.MhaFunction.apply(q, k, v, None, seed, 4, True,
                                         0.25, False, 0.1)

    grads, o = {}, {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)
        before = mha_ops.mha_forward.launches
        calls = []
        plain = mha_ops.mha_forward_plain

        def counted(*a, **kw):
            calls.append(1)
            return plain(*a, **kw)
        mha_ops.mha_forward_plain = counted
        try:
            out = remat_call(attend, gen, q, k, v) if remat else \
                attend(q, k, v, gen)
            out.square().sum().backward()
        finally:
            mha_ops.mha_forward_plain = plain
        assert mha_ops.mha_forward.launches == before   # CPU: no kernel
        assert len(calls) == (2 if remat else 1)
        o[remat] = out.detach()
        grads[remat] = [t.grad.clone() for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
    assert torch.equal(o[True], o[False])
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


def test_remat_step_matches_jax_remat_step():
    hp = small_test_config(remat=True, **NO_DROPOUT)
    model = init_weights_(ByteToMel(hp, device="cpu"), SEED)
    variables = jax_variables_from_state_dict(model.state_dict())
    batch = make_batch(hp, seed=SEED)
    optimizer, scheduler = make_optimizer(model, hp)
    dbatch = device_batch(batch, hp, "cpu")
    # the mels the port trained on: through the int16 wire of device_batch
    assert hp.wire_mel_int16
    batch["mel_targets"] = dbatch["mel_targets"].numpy()
    grads, want_losses, _ = _jax_grads(variables, batch,
                                       jax_cfg(remat=True, **NO_DROPOUT))
    out = train_step(model, optimizer, scheduler, dbatch, hp,
                     step_generator(SEED, 0, "cpu"))
    for key in ("loss", "bef_loss", "aft_loss", "stop_loss", "l2"):
        np.testing.assert_allclose(out[key].item(), float(want_losses[key]),
                                   rtol=1e-5, err_msg=key)
    want = state_dict_from_jax_variables(
        {"params": jax.tree.map(np.asarray, grads)})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        bound = 1e-5 * float(g.abs().max()) + 1e-7
        err = float((got[name] - g).abs().max())
        assert err <= bound, (name, err, bound)


def test_remat_keeps_the_state_dict():
    plain = ByteToMel(small_test_config(), device="cpu").state_dict()
    remat = ByteToMel(small_test_config(remat=True), device="cpu").state_dict()
    assert list(remat) == list(plain)
    assert all(remat[k].shape == plain[k].shape for k in plain)
