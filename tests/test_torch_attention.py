"""The port's attention: ``mha_forward`` (CPU path, the kernel's plain
version) against the JAX package's Pallas kernel ``mha_train`` in interpret
mode, and the port's ``MultiheadAttention`` against the JAX module.

Tolerances: fp32 throughout; 2e-5 for the kernel counterpart (as the JAX
package's own kernel tests), 1e-5 for the module paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

from few_shot_transformer_tts_tpu.models.attention import \
    MultiheadAttention as JaxMHA
from few_shot_transformer_tts_tpu.models.common import \
    causal_bias as jax_causal_bias
from few_shot_transformer_tts_tpu.ops.pallas_attention_train import mha_train
from few_shot_transformer_tts_torch.models.attention import MultiheadAttention
from few_shot_transformer_tts_torch.models.common import causal_bias
from few_shot_transformer_tts_torch.ops.mha import (
    check_alignment, mha_forward, mha_forward_plain)
from few_shot_transformer_tts_torch.train.converter import \
    state_dict_from_jax_variables

H, D = 3, 64


def _qkv(b, tq, tk, seed, valid=None):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, tq, H * D) * 0.3).astype(np.float32)
    k = (rng.randn(b, tk, H * D) * 0.3).astype(np.float32)
    v = rng.randn(b, tk, H * D).astype(np.float32)
    valid = valid if valid is not None else [tk] * b
    bias = np.where(np.arange(tk)[None, :] < np.asarray(valid)[:, None],
                    0.0, -1e20).astype(np.float32)
    return q, k, v, bias


def _lse_reference(q, k, bias, scale, causal):
    b, tq, _ = q.shape
    tk = k.shape[1]
    qh = q.reshape(b, tq, H, D).astype(np.float64) * scale
    kh = k.reshape(b, tk, H, D).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", qh, kh)
    if causal:
        s = np.where(np.tril(np.ones((tq, tk), bool)), s, -1e20)
    else:
        s = s + bias[:, None, None, :]
    return logsumexp(s, axis=-1).transpose(0, 2, 1)       # [B, Tq, H]


@pytest.mark.parametrize("b,tq,tk,causal,scale,valid", [
    (2, 50, 70, False, 1.0, [70, 40]),
    (2, 40, 40, True, 0.125, None),
    (1, 600, 600, False, 0.125, [570]),
], ids=["bias", "causal", "tq600"])
def test_mha_forward_matches_pallas_interpret(b, tq, tk, causal, scale,
                                              valid):
    q, k, v, bias = _qkv(b, tq, tk, seed=tq, valid=valid)
    use_bias = not causal
    bias_in = bias if use_bias else np.zeros_like(bias)
    want = mha_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(bias_in), jnp.zeros((1, 1), jnp.int32), H,
                     0.0, causal, scale, True, None, use_bias)
    before = mha_forward.launches
    o, lse = mha_forward(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(bias), H,
                         causal, scale, use_bias)
    assert mha_forward.launches == before      # CPU tensors: no kernel
    assert o.shape == (b, tq, H * D) and lse.shape == (b, tq, H)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(),
                               _lse_reference(q, k, bias, scale, causal),
                               rtol=1e-5, atol=2e-5)


def test_mha_forward_takes_strided_views_of_a_fused_projection():
    q, k, v, bias = _qkv(2, 24, 24, seed=7)
    fused = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    qs, ks, vs = fused.split([H * D] * 3, -1)
    assert qs.stride(1) == 3 * H * D
    o1, l1 = mha_forward(qs, ks, vs, torch.from_numpy(bias), H, False, 0.125,
                         True)
    o2, l2 = mha_forward_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(bias),
                               H, False, 0.125, True)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)


def test_alignment_check_passes_split_views_of_fused_projections():
    """The bf16 kernels' 16-byte rule holds for what the model hands over:
    q, k, v split from a fused QKV, and k, v split from a fused KV."""
    c = H * D
    qkv = torch.zeros(2, 24, 3 * c, dtype=torch.bfloat16)
    check_alignment(*qkv.split([c] * 3, -1))
    q = torch.zeros(2, 24, c, dtype=torch.bfloat16)
    kv = torch.zeros(2, 30, 2 * c, dtype=torch.bfloat16)
    check_alignment(q, *kv.split([c, c], -1))


@pytest.mark.parametrize("view", ["base_offset", "row_stride",
                                  "batch_stride"])
def test_alignment_check_rejects_views_off_16_bytes(view):
    c = H * D
    if view == "base_offset":     # starts 2 bytes into a 16-byte step
        t = torch.zeros(2, 24, c + 8, dtype=torch.bfloat16)[..., 1:1 + c]
    elif view == "row_stride":    # rows 2 * (c + 1) bytes apart
        t = torch.zeros(2, 24, c + 1, dtype=torch.bfloat16)[..., :c]
    else:                         # batch rows 8 bytes off a 16-byte step
        t = torch.zeros(2 * (24 * c + 4), dtype=torch.bfloat16).as_strided(
            (2, 24, c), (24 * c + 4, c, 1))
    with pytest.raises(ValueError, match="16-byte"):
        check_alignment(t)


def test_mha_forward_rejects_what_the_kernel_does_not_take():
    q, k, v, bias = (torch.from_numpy(a) for a in _qkv(1, 8, 8, seed=1))
    with pytest.raises(ValueError, match="seed"):
        mha_forward(q, k, v, bias, H, False, 1.0, True, rate=0.1)
    with pytest.raises(ValueError, match="rate"):
        mha_forward(q, k, v, bias, H, False, 1.0, True, rate=1.0,
                    seed=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="Tq == Tk"):
        mha_forward(q, k[:, :4], v[:, :4], None, H, True, 1.0, False)
    with pytest.raises(ValueError, match="bias"):
        mha_forward(q, k, v, None, H, False, 1.0, True)


# ---------------------------------------------------------------------------
# MultiheadAttention module
# ---------------------------------------------------------------------------

C, HEADS = 48, 4


def _module_pair(is_self, seed=0):
    jm = JaxMHA(key_size=C, value_size=C, is_self_attention=is_self,
                num_heads=HEADS, dropout_rate=0.1)
    x = jnp.zeros((1, 3, C), jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), x, None if is_self else x,
                     None)
    params = jax.tree.map(np.asarray, params)
    tm = MultiheadAttention(C, C, C, C, is_self, HEADS, dropout_rate=0.1,
                            use_kernel=True)
    tm.load_state_dict(state_dict_from_jax_variables(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("is_self", [True, False], ids=["self", "cross"])
def test_module_full_sequence_matches_jax(is_self):
    jm, params, tm = _module_pair(is_self)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, C).astype(np.float32)
    mem = rng.randn(2, 11, C).astype(np.float32)
    if is_self:
        jbias, tbias, memories = jax_causal_bias(9), causal_bias(9), None
    else:
        mask = np.arange(11)[None, :] < np.asarray([11, 6])[:, None]
        jbias = ((1.0 - mask) * -1e20)[:, None, None, :].astype(np.float32)
        tbias, memories = torch.from_numpy(jbias), mem
    want, want_align = jm.apply(
        params, jnp.asarray(x), None if memories is None else
        jnp.asarray(memories), jnp.asarray(jbias), True, True)
    got, got_align = tm(torch.from_numpy(x), None if memories is None else
                        torch.from_numpy(memories), tbias, True, True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(got_align.detach().numpy(),
                               np.asarray(want_align), atol=1e-5)
    # use_kernel with CPU tensors keeps the plain split-head path
    no_align, _ = tm(torch.from_numpy(x), None if memories is None else
                     torch.from_numpy(memories), tbias, True, False)
    np.testing.assert_allclose(no_align.detach().numpy(), np.asarray(want),
                               atol=1e-5)


@torch.no_grad()
def test_module_decode_steps_match_jax():
    jm, params, tm = _module_pair(True, seed=1)
    rng = np.random.RandomState(4)
    cap, b, d = 7, 2, C // HEADS
    jk = jnp.zeros((b, HEADS, cap, d))
    jv = jnp.zeros((b, HEADS, cap, d))
    tk = torch.zeros(b, HEADS, cap, d)
    tv = torch.zeros(b, HEADS, cap, d)
    for step in range(4):
        x = rng.randn(b, C).astype(np.float32)
        want, jk, jv, want_align = jm.apply(
            params, jnp.asarray(x), jk, jv, jnp.asarray(step, jnp.int32),
            method=JaxMHA.decode_self_step)
        got, got_align = tm.decode_self_step(torch.from_numpy(x), tk, tv,
                                             step)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
        np.testing.assert_allclose(got_align.numpy(),
                                   np.asarray(want_align)[..., :step + 1],
                                   atol=1e-5)
        assert np.all(np.asarray(want_align)[..., step + 1:] == 0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)

    jm, params, tm = _module_pair(False, seed=2)
    mem = rng.randn(b, 5, C).astype(np.float32)
    mask = np.arange(5)[None, :] < np.asarray([5, 3])[:, None]
    mem_bias = ((1.0 - mask) * -1e20)[:, None, None, :].astype(np.float32)
    jmk, jmv = jm.apply(params, jnp.asarray(mem), method=JaxMHA.project_kv)
    tmk, tmv = tm.project_kv(torch.from_numpy(mem))
    np.testing.assert_allclose(tmk.detach().numpy(), np.asarray(jmk),
                               atol=1e-5)
    x = rng.randn(b, C).astype(np.float32)
    want, want_align = jm.apply(params, jnp.asarray(x), jmk, jmv,
                                jnp.asarray(mem_bias),
                                method=JaxMHA.decode_cross_step)
    got, got_align = tm.decode_cross_step(torch.from_numpy(x), tmk, tmv,
                                          torch.from_numpy(mem_bias))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(got_align.detach().numpy(),
                               np.asarray(want_align), atol=1e-5)
