"""The training kernels' plain versions against the JAX package's Pallas
kernels in interpret mode, and the autograd Functions that carry them.

- ``mha_backward_plain`` against ``jax.vjp`` of ``mha_train`` at rate 0
  (self-attention with bias, causal, cross-attention with bias; Tk not a
  multiple of 32; head dim 64, and 32, 48, 128, 288, 384, 512 and 1024).
  Tolerance 2e-5, as for the forward.
- ``MhaFunction``'s gradients against torch autograd through
  ``mha_forward_plain`` at rates 0 and 0.1 (one mask function serves both).
  Tolerance 1e-5: the same fp32 math in another order.
- The dropout mask: Philox's known-answer vectors, the keep share over 1e6
  draws within 0.005 of 0.9, equal across calls, different across seeds,
  heads and batch rows.
- ``layer_norm_backward_plain`` against ``jax.vjp`` of ``fused_layer_norm``
  in interpret mode (rows 1000 and 7, C 32 and 48; the flagship widths 512
  and 768 at 64 and 33 rows).  Tolerance 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from few_shot_transformer_tts_tpu.ops.fused_layernorm import \
    fused_layer_norm
from few_shot_transformer_tts_tpu.ops.pallas_attention_train import mha_train
from few_shot_transformer_tts_torch.ops.layernorm import (
    LayerNorm, LayerNormFunction, layer_norm, layer_norm_backward,
    layer_norm_backward_plain)
from few_shot_transformer_tts_torch.ops.mha import (
    MhaFunction, check_alignment, dropout_keep_mask, mha_backward,
    mha_backward_plain, mha_forward, mha_forward_plain, philox4x32_10)

H, D = 3, 64

CASES = {
    "self_bias": dict(b=2, tq=45, tk=45, causal=False, valid=[45, 30]),
    "causal": dict(b=2, tq=37, tk=37, causal=True, valid=None),
    "cross_bias": dict(b=2, tq=40, tk=70, causal=False, valid=[70, 41]),
    # head dims of other instantiations: 32, 48 (run padded to 64), 128
    "self_bias_d32": dict(b=2, tq=45, tk=45, causal=False, valid=[45, 30],
                          d=32),
    "causal_d48": dict(b=2, tq=37, tk=37, causal=True, valid=None, d=48),
    "cross_bias_d128": dict(b=2, tq=40, tk=70, causal=False, valid=[70, 41],
                            d=128),
    # above 256, the run-time head dim of csrc/mha_wide.cu
    "causal_d288": dict(b=2, tq=33, tk=33, causal=True, valid=None, d=288),
    "cross_bias_d384": dict(b=2, tq=29, tk=41, causal=False, valid=[41, 17],
                            d=384),
    "causal_d512": dict(b=2, tq=35, tk=35, causal=True, valid=None, d=512),
    "cross_bias_d1024": dict(b=1, tq=27, tk=38, causal=False, valid=[38],
                             d=1024),
}


def _inputs(b, tq, tk, causal, valid, seed, d=D):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, tq, H * d) * 0.3).astype(np.float32)
    k = (rng.randn(b, tk, H * d) * 0.3).astype(np.float32)
    v = rng.randn(b, tk, H * d).astype(np.float32)
    do = rng.randn(b, tq, H * d).astype(np.float32)
    valid = valid if valid is not None else [tk] * b
    bias = np.where(np.arange(tk)[None, :] < np.asarray(valid)[:, None],
                    0.0, -1e20).astype(np.float32)
    return q, k, v, bias, do


@pytest.mark.parametrize("case", sorted(CASES))
def test_mha_backward_plain_matches_pallas_vjp(case):
    c = CASES[case]
    q, k, v, bias, do = _inputs(seed=len(case), **c)
    causal, use_bias, scale = c["causal"], not c["causal"], 0.125
    jbias = jnp.asarray(bias if use_bias else np.zeros_like(bias))
    _, vjp = jax.vjp(
        lambda q_, k_, v_: mha_train(q_, k_, v_, jbias,
                                     jnp.zeros((1, 1), jnp.int32), H, 0.0,
                                     causal, scale, True, None, use_bias),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    t = [torch.from_numpy(a) for a in (q, k, v, bias, do)]
    args = (t[0], t[1], t[2], t[3], H, causal, scale, use_bias)
    o, lse = mha_forward(*args)
    before = mha_backward.launches
    got = mha_backward(t[0], t[1], t[2], t[3], None, o, lse, t[4], H,
                       causal, scale, use_bias)
    assert mha_backward.launches == before       # CPU tensors: no kernel
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mha_function_grads_match_autograd_of_plain_forward(case, rate):
    c = CASES[case]
    q, k, v, bias, do = (torch.from_numpy(a)
                         for a in _inputs(seed=7, **c))
    causal, use_bias = c["causal"], not c["causal"]
    seed = torch.tensor([987654321], dtype=torch.int64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_plain, _ = mha_forward_plain(*leaves, bias, H, causal, 0.125,
                                   use_bias, rate, seed)
    want = torch.autograd.grad(o_plain, leaves, do)
    leaves2 = [x.clone().requires_grad_() for x in (q, k, v)]
    o = MhaFunction.apply(*leaves2, bias, seed, H, causal, 0.125, use_bias,
                          rate)
    torch.testing.assert_close(o, o_plain.detach(), rtol=0, atol=0)
    got = torch.autograd.grad(o, leaves2, do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=name)


def test_dropout_changes_the_output_and_keeps_its_expectation():
    q, k, v, bias, _ = (torch.from_numpy(a) for a in
                        _inputs(1, 40, 40, False, None, seed=3))
    args = (q, k, v, bias, H, False, 0.125, True)
    o0, lse0 = mha_forward(*args)
    seed = torch.tensor([5], dtype=torch.int64)
    o1, lse1 = mha_forward(*args, rate=0.1, seed=seed)
    torch.testing.assert_close(lse1, lse0, rtol=0, atol=0)  # unmasked l
    assert (o1 - o0).abs().max() > 1e-3
    # the same seed gives the same output; another seed another
    torch.testing.assert_close(mha_forward(*args, rate=0.1, seed=seed)[0],
                               o1, rtol=0, atol=0)
    o2, _ = mha_forward(*args, rate=0.1, seed=seed + 1)
    assert (o2 - o1).abs().max() > 1e-3


def test_philox_known_answers():
    """Random123's philox4x32_10 known-answer vectors."""
    t = lambda x: torch.tensor([x], dtype=torch.int64)
    m = 0xFFFFFFFF
    for args, want in [
            ((0, 0, 0, 0, 0, 0),
             (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((m, m, m, m, m, m),
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))]:
        got = philox4x32_10(*(t(a) for a in args))
        assert tuple(int(w) for w in got) == want


def test_dropout_mask_share_and_determinism():
    seed = torch.tensor([123456789012], dtype=torch.int64)
    mask = dropout_keep_mask(seed, 4, 8, 192, 192, 0.1)   # 1.18e6 draws
    assert mask.shape == (4, 8, 192, 192) and mask.dtype == torch.bool
    assert abs(mask.float().mean().item() - 0.9) < 0.005
    assert torch.equal(mask, dropout_keep_mask(seed, 4, 8, 192, 192, 0.1))
    other = dropout_keep_mask(seed + 1, 4, 8, 192, 192, 0.1)
    assert (other != mask).float().mean() > 0.1
    # distinct streams per head and per batch row (and per query row)
    assert (mask[:, 0] != mask[:, 1]).float().mean() > 0.1
    assert (mask[0] != mask[1]).float().mean() > 0.1
    assert (mask[:, :, 0] != mask[:, :, 1]).float().mean() > 0.1
    # a ragged key count is a prefix of the padded one
    short = dropout_keep_mask(seed, 4, 8, 192, 77, 0.1)
    assert torch.equal(short, mask[..., :77])
    assert dropout_keep_mask(seed, 1, 1, 4, 4, 0.0).all()


@pytest.mark.parametrize("rows,c", [(1000, 32), (1000, 48), (7, 32),
                                    (7, 48), (64, 512), (33, 768)])
def test_layer_norm_backward_plain_matches_pallas_vjp(rows, c):
    rng = np.random.RandomState(rows + c)
    x = (rng.randn(rows, c) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(rows, c).astype(np.float32)
    y, vjp = jax.vjp(lambda x_, g_, b_: fused_layer_norm(x_, g_, b_, 1e-6,
                                                         True),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want = vjp(jnp.asarray(dy))
    tx, tg, tdy = (torch.from_numpy(a) for a in (x, gamma, dy))
    np.testing.assert_allclose(
        layer_norm(tx, tg, torch.from_numpy(beta)).numpy(), np.asarray(y),
        atol=1e-5)
    before = layer_norm_backward.launches
    got = layer_norm_backward(tx, tg, tdy)
    assert layer_norm_backward.launches == before  # CPU tensors: no kernel
    for g, w, name in zip(got, want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    want_plain = layer_norm_backward_plain(tx, tg, tdy)
    for g, w in zip(got, want_plain):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_layer_norm_function_matches_autograd_of_plain_forward():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 11, 48).astype(np.float32))
    ln = LayerNorm(48, fused=True)
    with torch.no_grad():
        ln.weight.add_(torch.from_numpy(0.1 * rng.randn(48).astype(
            np.float32)))
        ln.bias.add_(0.2)
    dy = torch.from_numpy(rng.randn(3, 11, 48).astype(np.float32))
    xs = [x.clone().requires_grad_() for _ in range(2)]
    y_fused = ln(xs[0])
    y_plain = layer_norm(xs[1], ln.weight, ln.bias)
    torch.testing.assert_close(y_fused, y_plain, rtol=0, atol=0)
    got = torch.autograd.grad(y_fused, (xs[0], ln.weight, ln.bias), dy)
    want = torch.autograd.grad(y_plain, (xs[1], ln.weight, ln.bias), dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # without autograd the module takes the plain forward
    with torch.no_grad():
        torch.testing.assert_close(ln(x), y_plain.detach(), rtol=0, atol=0)
    # the Function directly, as the fused module calls it
    y = LayerNormFunction.apply(xs[0], ln.weight, ln.bias, 1e-6)
    torch.testing.assert_close(y, y_plain, rtol=0, atol=0)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, bias, do = (torch.from_numpy(a) for a in
                         _inputs(1, 8, 8, False, None, seed=1))
    o, lse = mha_forward(q, k, v, bias, H, False, 1.0, True)
    with pytest.raises(ValueError, match="seed"):
        mha_backward(q, k, v, bias, None, o, lse, do, H, False, 1.0, True,
                     0.1)
    with pytest.raises(ValueError, match="seed"):
        mha_forward(q, k, v, bias, H, False, 1.0, True, 0.1,
                    torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="on CPU or CUDA"):
        layer_norm_backward(q.to("meta"), torch.ones(H * D),
                            do.to("meta"))
    got = mha_backward_plain(q, k, v, bias, None, o, lse, do, H, False, 1.0,
                             True)
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]


def test_backward_inputs_meet_the_alignment_rule():
    """q, k, v split from a fused QKV, the forward's o and a fresh gradient
    pass the bf16 kernels' 16-byte rule; an o shifted by 8 bytes does not."""
    c = H * D
    qkv = torch.from_numpy(np.random.RandomState(3).randn(
        2, 24, 3 * c).astype(np.float32)).to(torch.bfloat16)
    q, k, v = qkv.split([c] * 3, -1)
    o, lse = mha_forward(q, k, v, None, H, True, 0.125, False)
    check_alignment(q, k, v, o, torch.ones_like(o))
    shifted = torch.zeros(2, 24, c + 4, dtype=torch.bfloat16)[..., 4:]
    with pytest.raises(ValueError, match="16-byte"):
        check_alignment(q, k, v, shifted)
