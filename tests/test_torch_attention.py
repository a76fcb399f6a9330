"""The port's attention: ``mha_forward`` (CPU path, the kernel's plain
version) against the JAX package's Pallas kernel ``mha_train`` in interpret
mode (head dims 64, and 32, 48, 128, and 288, 384, 512 and 1024 of
csrc/mha_wide.cu), the head-dim rule of the CUDA kernels and the padding it
implies, the wide kernels' workspaces, and the port's
``MultiheadAttention`` against the JAX module.

Tolerances: fp32 throughout; 2e-5 for the kernel counterpart (as the JAX
package's own kernel tests), 1e-5 for the module paths; padded heads give
the unpadded plain result bit for bit.
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
from few_shot_transformer_tts_torch.ops import cuda_build
from few_shot_transformer_tts_torch.ops.mha import (
    KERNEL_HEAD_DIMS, MAX_HEAD_DIM, check_alignment, kernel_head_dim,
    mha_backward_plain, mha_forward, mha_forward_plain, pad_heads,
    unpad_heads, wide_workspace)
from few_shot_transformer_tts_torch.train.converter import \
    state_dict_from_jax_variables

H, D = 3, 64


def _qkv(b, tq, tk, seed, valid=None, d=D):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, tq, H * d) * 0.3).astype(np.float32)
    k = (rng.randn(b, tk, H * d) * 0.3).astype(np.float32)
    v = rng.randn(b, tk, H * d).astype(np.float32)
    valid = valid if valid is not None else [tk] * b
    bias = np.where(np.arange(tk)[None, :] < np.asarray(valid)[:, None],
                    0.0, -1e20).astype(np.float32)
    return q, k, v, bias


def _lse_reference(q, k, bias, scale, causal):
    b, tq, c = q.shape
    tk = k.shape[1]
    qh = q.reshape(b, tq, H, c // H).astype(np.float64) * scale
    kh = k.reshape(b, tk, H, c // H).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", qh, kh)
    if causal:
        s = np.where(np.tril(np.ones((tq, tk), bool)), s, -1e20)
    else:
        s = s + bias[:, None, None, :]
    return logsumexp(s, axis=-1).transpose(0, 2, 1)       # [B, Tq, H]


@pytest.mark.parametrize("b,tq,tk,causal,scale,valid,d", [
    (2, 50, 70, False, 1.0, [70, 40], 64),
    (2, 40, 40, True, 0.125, None, 64),
    (1, 600, 600, False, 0.125, [570], 64),
    (2, 50, 70, False, 32 ** -0.5, [70, 40], 32),
    (2, 40, 40, True, 48 ** -0.5, None, 48),
    (2, 37, 45, False, 128 ** -0.5, [45, 20], 128),
    (2, 33, 33, True, 288 ** -0.5, None, 288),
    (2, 29, 41, False, 384 ** -0.5, [41, 17], 384),
    (2, 35, 35, True, 512 ** -0.5, None, 512),
    (1, 27, 38, False, 1024 ** -0.5, [38], 1024),
], ids=["bias", "causal", "tq600", "d32_bias", "d48_causal", "d128_bias",
        "d288_causal", "d384_bias", "d512_causal", "d1024_bias"])
def test_mha_forward_matches_pallas_interpret(b, tq, tk, causal, scale,
                                              valid, d):
    q, k, v, bias = _qkv(b, tq, tk, seed=tq, valid=valid, d=d)
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
    assert o.shape == (b, tq, H * d) and lse.shape == (b, tq, H)
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


def test_head_dim_rule_picks_the_next_multiple_of_32():
    """Which kernel takes which head dim, checked without building: a
    multiple of 32 up to 256 runs on its own instantiation, above 256 on the
    run-time head dim of csrc/mha_wide.cu, any other D up to 1024 on the
    next multiple of 32 (padded), and above 1024 nothing."""
    assert KERNEL_HEAD_DIMS == (32, 64, 96, 128, 160, 192, 224, 256)
    assert MAX_HEAD_DIM == 1024
    for d in range(1, MAX_HEAD_DIM + 1):
        k = kernel_head_dim(d)
        assert k % 32 == 0 and d <= k < d + 32, d
        assert (k == d) == (d % 32 == 0), d
        assert (k in KERNEL_HEAD_DIMS) == (d <= 256), d
    assert [kernel_head_dim(d) for d in (8, 12, 48, 80, 96, 100, 200)] == \
        [32, 32, 64, 96, 96, 128, 224]
    # above 256: run (padded to a multiple of 32), not refused
    assert [kernel_head_dim(d) for d in (257, 288, 300, 384, 512, 768,
                                         1000, 1024)] == \
        [288, 288, 320, 384, 512, 768, 1024, 1024]
    for d in (1025, 1056, 2048, 0):
        with pytest.raises(ValueError, match="1 to 1024"):
            kernel_head_dim(d)
    # one library per (source, head dim), named and hashed by it, and a
    # per-head-dim source without one is refused before any build
    paths = {cuda_build.library_path(name, d)
             for name in cuda_build.HEAD_DIM_SOURCES
             for d in KERNEL_HEAD_DIMS}
    assert len(paths) == 2 * len(KERNEL_HEAD_DIMS)
    assert cuda_build.library_path("mha_fwd", 128).name.startswith(
        "libmha_fwd-d128-")
    with pytest.raises(ValueError, match="once per head dim"):
        cuda_build.load("mha_bwd")
    with pytest.raises(ValueError, match="without a head dim"):
        cuda_build.load("fused_adam", 64)
    # above 256 one library, built without a head dim
    assert "mha_wide" in cuda_build.sources()
    assert "mha_wide" not in cuda_build.HEAD_DIM_SOURCES
    with pytest.raises(ValueError, match="without a head dim"):
        cuda_build.load("mha_wide", 384)


def test_wide_workspaces_hold_every_tile():
    """csrc/mha_wide.cu's workspaces: Tq and Tk rounded up to its 64-row
    tiles; forward fp32, per query row its scores, one maximum and two mask
    words per key tile (a tile: 4096 scores, 64 maxima, 128 words);
    backward bf16, round(g) and round(ds * scale) of every pair."""
    for b, h, tq, tk in ((16, 2, 448, 448), (16, 2, 448, 192), (3, 1, 141,
                                                                    141),
                         (4, 2, 200, 50), (1, 3, 1, 1), (2, 1, 64, 65)):
        nq, nk = -(-tq // 64), -(-tk // 64)
        shape, dtype = wide_workspace("forward", b, h, tq, tk)
        assert dtype == torch.float32
        assert shape == (b, h, nq * 64, nk * 64 + 3 * nk)
        assert int(np.prod(shape)) == b * h * nq * nk * (4096 + 64 + 128)
        shape, dtype = wide_workspace("backward", b, h, tq, tk)
        assert dtype == torch.bfloat16
        assert shape == (2, b, h, nq * 64, nk * 64)
    # the flagship decoder's train shape with 2 heads (D=384): ~26 MB each
    fwd, _ = wide_workspace("forward", 16, 2, 448, 448)
    bwd, _ = wide_workspace("backward", 16, 2, 448, 448)
    assert int(np.prod(fwd)) * 4 == 26_894_336
    assert int(np.prod(bwd)) * 2 == 25_690_112
    with pytest.raises(ValueError, match="direction"):
        wide_workspace("sideways", 1, 1, 1, 1)


@pytest.mark.parametrize("d", [8, 12, 48])
@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.1)],
                         ids=["bias", "causal_dropout"])
def test_padded_heads_give_the_unpadded_result_bit_for_bit(d, causal, rate):
    """The kernels' padding, around the plain versions in fp32: zero channels
    add nothing to q.k, give zero output columns and zero gradient columns,
    and the softmax scale is the caller's, so slicing the padded result
    back gives the unpadded result's bits (o, lse, dq, dk, dv)."""
    b, t = 2, 45
    q, k, v, bias = (torch.from_numpy(a) for a in _qkv(
        b, t, t, seed=d, valid=[t, 30], d=d))
    do = torch.from_numpy(np.random.RandomState(d + 1).randn(
        b, t, H * d).astype(np.float32))
    seed = torch.tensor([424242], dtype=torch.int64)
    use_bias, scale = not causal, d ** -0.5
    dp = kernel_head_dim(d)
    pad = lambda x: pad_heads(x, H, dp)
    assert pad(q).shape == (b, t, H * dp)
    assert not pad(q).reshape(b, t, H, dp)[..., d:].any()
    torch.testing.assert_close(unpad_heads(pad(q), H, d), q, rtol=0, atol=0)

    o, lse = mha_forward_plain(q, k, v, bias, H, causal, scale, use_bias,
                               rate, seed)
    op, lsep = mha_forward_plain(pad(q), pad(k), pad(v), bias, H, causal,
                                 scale, use_bias, rate, seed)
    assert not op.reshape(b, t, H, dp)[..., d:].any()
    assert torch.equal(unpad_heads(op, H, d), o) and torch.equal(lsep, lse)
    grads = mha_backward_plain(q, k, v, bias, seed, o, lse, do, H, causal,
                               scale, use_bias, rate)
    padded = mha_backward_plain(pad(q), pad(k), pad(v), bias, seed, op,
                                lsep, pad(do), H, causal, scale, use_bias,
                                rate)
    for g, gp, name in zip(grads, padded, ("dq", "dk", "dv")):
        assert not gp.reshape(b, t, H, dp)[..., d:].any(), name
        assert torch.equal(unpad_heads(gp, H, d), g), name


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
