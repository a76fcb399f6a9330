"""Two properties of training that the gradient test at fp32 does not see,
held against the JAX package:

- the port's ``init_weights_`` draws every leaf from the distribution the
  JAX package's ``create_state`` draws it from (the flagship widths, two
  layers each side): per leaf of 1000 elements or more, the standard
  deviation within 5% and the mean within 5% of it; every smaller leaf the
  same values where the JAX init is constant;
- one step in bf16 at dropout 0 from the same weights: the losses within
  bf16 rounding of the JAX package's, and the port's gradients no further
  from the fp32 gradients than the JAX package's bf16 gradients are
  (leaf by leaf: at most 2x the JAX package's distance or 0.02, and in
  the median at most 1.25x), so its bf16 rounding points lose no more
  than the reference's.
"""

import jax
import numpy as np
import torch

from few_shot_transformer_tts_tpu.config import default_config as jax_default
from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.models.tacotron import \
    ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.train.loop import create_state
from few_shot_transformer_tts_torch.config import default_config, \
    small_test_config
from few_shot_transformer_tts_torch.models.tacotron import (
    ByteToMel, compute_loss, init_weights_)
from few_shot_transformer_tts_torch.train.converter import \
    state_dict_from_jax_variables

from test_torch_train import _jax_grads, make_batch
from test_torch_weights import jax_variables

NO_DROPOUT = dict(transformer_dropout_rate=0.0, decoder_dropout_rate=0.0)


def test_init_statistics_match_the_jax_init():
    over = dict(n_encoder_layer=2, n_decoder_layer=2, use_bfloat16=False)
    hp_jax = jax_default().replace(**over)
    b = 2
    batch = dict(
        inputs=np.full((b, 32), 5, np.int32),
        input_lengths=np.full(b, 32, np.int32),
        mel_targets=np.zeros((b, 64, 80), np.float32),
        target_lengths=np.full(b, 64, np.int32),
        input_spk_ids=np.zeros(b, np.int32),
        input_language_vecs=np.eye(hp_jax.max_num_language,
                                   dtype=np.float32)[[0, 1]])
    state = create_state(JaxByteToMel(hp_jax), hp_jax, 0, batch)
    want = state_dict_from_jax_variables({
        "params": jax.device_get(state.params),
        "batch_stats": jax.device_get(state.batch_stats)})
    got = init_weights_(ByteToMel(default_config(**over), device="cpu"),
                        0).state_dict()
    assert sorted(got) == sorted(want)
    checked = 0
    for name, t in got.items():
        p = t.double().numpy()
        j = torch.as_tensor(want[name]).double().numpy()
        assert p.shape == j.shape, name
        if p.size >= 1000:
            assert abs(p.std() - j.std()) <= 0.05 * j.std(), name
            assert abs(p.mean() - j.mean()) <= 0.05 * j.std(), name
            checked += 1
        elif np.all(j == j.flat[0]):      # zeros, ones, counters
            np.testing.assert_array_equal(p, j, err_msg=name)
    assert checked >= 30


def _bf16_step(variables, batch, bf16):
    over = dict(NO_DROPOUT, use_bfloat16=bf16)
    grads, want_losses, _ = _jax_grads(variables, batch, jax_cfg(**over))
    hp = small_test_config(**over)
    model = ByteToMel(hp, device="cpu")
    model.load_state_dict(state_dict_from_jax_variables(variables),
                          strict=True)
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["inputs"], tb["input_lengths"], tb["mel_targets"],
                tb["target_lengths"], tb["input_spk_ids"],
                tb["input_language_vecs"], train=True)
    losses = compute_loss(model, tb["mel_targets"], tb["target_lengths"],
                          out, hp)
    losses["loss"].backward()
    port = {n: p.grad.double() for n, p in model.named_parameters()}
    ref = {n: g.double() for n, g in
           state_dict_from_jax_variables({"params": grads}).items()}
    return losses, want_losses, port, ref


def test_bf16_step_loses_no_more_than_the_jax_package():
    variables = jax_variables(5, **NO_DROPOUT)
    batch = make_batch(small_test_config(), b=8, t_in=32, t_out=64, seed=5)
    _, _, exact, _ = _bf16_step(variables, batch, bf16=False)
    losses, want_losses, port, jax_bf16 = _bf16_step(variables, batch,
                                                     bf16=True)
    for key in ("loss", "bef_loss", "aft_loss", "stop_loss"):
        np.testing.assert_allclose(losses[key].item(),
                                   float(want_losses[key]), rtol=2e-3,
                                   err_msg=key)
    dist = lambda g, n: float((g - exact[n]).norm() /
                              (exact[n].norm() + 1e-30))
    ours, theirs = [], []
    for name in exact:
        d_port, d_jax = dist(port[name], name), dist(jax_bf16[name], name)
        assert d_port <= max(2.0 * d_jax, 0.02), (name, d_port, d_jax)
        ours.append(d_port)
        theirs.append(d_jax)
    assert np.median(ours) <= 1.25 * np.median(theirs)
