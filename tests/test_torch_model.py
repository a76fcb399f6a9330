"""The port's Byte2Speech model against the JAX package's, eval-mode
teacher-forced forward, fp32 at small_test_config (tolerance 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.models import ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.ops.fused_layernorm import reference_ln
from few_shot_transformer_tts_torch.ops.layernorm import layer_norm

from test_torch_weights import (NO_CONDITIONING, example_batch, jax_variables,
                                port_model)


def _teacher_forced(overrides, batch, **kw):
    variables = jax_variables(11, **overrides)
    hp = jax_cfg(**overrides)
    jax_out = JaxByteToMel(hp).apply(
        variables, **{k: jnp.asarray(v) for k, v in batch.items()},
        train=False, **kw)
    with torch.no_grad():
        out = port_model(variables, **overrides)(
            **{k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    return jax_out, out


@pytest.mark.parametrize("overrides", [{}, NO_CONDITIONING],
                         ids=["conditioned", "unconditioned"])
def test_teacher_forced_matches_jax(overrides):
    hp = jax_cfg(**overrides)
    batch = example_batch(hp, b=2, t_in=10, t_out=12, seed=1)
    if not hp.multi_speaker:
        batch.pop("input_spk_ids")
    if not hp.multi_lingual:
        batch.pop("input_language_vecs")
    want, got = _teacher_forced(overrides, batch)
    for key in ("mel_bef", "mel_aft", "stop_logits"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)
    # the postnet's running statistics are non-trivial, so it is exercised
    assert np.abs(got["mel_aft"].numpy() - got["mel_bef"].numpy()).max() > 0.1
    # imputation beyond the target lengths
    assert np.all(got["mel_bef"].numpy()[1, 9:] == 0)


def test_teacher_forced_alignments_match_jax():
    hp = jax_cfg()
    batch = example_batch(hp, b=2, t_in=8, t_out=10, seed=2)
    want, got = _teacher_forced({}, batch, collect_alignments=True)
    for kind in ("self", "encdec"):
        assert len(got["alignments"][kind]) == hp.n_decoder_layer
        for w, g in zip(want["alignments"][kind], got["alignments"][kind]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       err_msg=kind)


def test_layer_norm_matches_reference_ln():
    rng = np.random.RandomState(0)
    x = (rng.randn(5, 7, 48) * 3 + 2).astype(np.float32)
    g = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    want = reference_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-6)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    bf = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g),
                    torch.from_numpy(b))
    assert bf.dtype == torch.bfloat16


def test_bf16_compute_keeps_fp32_outputs():
    """With use_bfloat16 the modules compute in bf16 (on the CPU here) and
    the float outputs come back fp32, close to the fp32 run."""
    variables = jax_variables(4)
    batch = example_batch(jax_cfg(), seed=3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        ref = port_model(variables)(**tb)
        out = port_model(variables, use_bfloat16=True)(**tb)
    for key in ("mel_bef", "mel_aft", "stop_logits"):
        assert out[key].dtype == torch.float32
        assert torch.isfinite(out[key]).all()
    err = (out["mel_bef"] - ref["mel_bef"]).abs().max().item()
    assert err < 0.1 * ref["mel_bef"].abs().max().item(), err
