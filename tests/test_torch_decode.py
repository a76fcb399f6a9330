"""The fused AR decode step of the port (``ops/decode.py``) and the fused
synthesis path that runs it, held to the JAX package.

Function level: ``decoder_frame_step`` (the plain version on CPU tensors)
against the JAX ``decoder_frame_step`` in Pallas interpret mode, fp32, at
the steps that cross the TPU kernel's 256-frame cache blocks, with both of
its memory branches (Tm=256 held in VMEM, Tm=512 streamed) and at D=96;
x_out, k_new and v_new within 1e-5 of their largest magnitude, the
cross-attention weights within 1e-6.  Then the weight stacking and memory
projection, ``synthesize_batch`` with ``use_pallas_decode`` against the JAX
fused path (FSTTS_PALLAS_INTERPRET=1) and against the port's eager path,
the dispatch rule, and self-alignment collection against JAX.  Last, the
fused frame loop that a card replays as a CUDA graph, run eagerly here:
against the per-frame code bit for bit, its device step against the host's,
``decoder_frame_step``'s ``out``, its frame counters and the benchmark's
reader of them.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from few_shot_transformer_tts_tpu.config import small_test_config as jax_cfg
from few_shot_transformer_tts_tpu.infer import \
    synthesize_batch as jax_synthesize_batch
from few_shot_transformer_tts_tpu.models import ByteToMel as JaxByteToMel
from few_shot_transformer_tts_tpu.ops import pallas_decode as jax_decode
from few_shot_transformer_tts_torch.infer import synthesize as syn
from few_shot_transformer_tts_torch.infer import synthesize_batch
from few_shot_transformer_tts_torch.ops import decode
from few_shot_transformer_tts_torch.utils import tracing

from test_torch_synthesize import HP, input_batch, with_stop_head
from test_torch_weights import jax_variables, port_model

FUSED = HP.replace(use_pallas_decode=True)
ROOT = Path(__file__).resolve().parents[1]
FRAME_STEP = decode.decoder_frame_step     # before any test replaces it


def step_inputs(seed, n_layers, b, c, t_cap, t_mem, valid):
    """Random fp32 kernel inputs (numpy): x, stacked weights at the init's
    scale, caches, memory K/V and a padding bias with ``valid`` columns per
    row."""
    rng = np.random.RandomState(seed)
    f = 4 * c
    w = lambda k, n: (rng.randn(n_layers, k, n) / np.sqrt(k)).astype(
        np.float32)
    lns = np.stack([1 + 0.1 * rng.randn(n_layers, c) if i % 2 == 0 else
                    0.1 * rng.randn(n_layers, c) for i in range(6)], 1)
    weights = {"lns": lns.astype(np.float32), "w_qkv": w(c, 3 * c),
               "w_out": w(c, c), "w_q": w(c, c), "w_xout": w(c, c),
               "w_ffn1": w(c, f), "w_ffn2": w(f, c)}
    arr = lambda *s: rng.randn(*s).astype(np.float32)
    bias = np.where(np.arange(t_mem)[None, :] < np.asarray(valid)[:, None],
                    0.0, -1e20).astype(np.float32)
    return (arr(b, c), weights, arr(n_layers, b, t_cap, c),
            arr(n_layers, b, t_cap, c), arr(n_layers, b, t_mem, c),
            arr(n_layers, b, t_mem, c), bias)


def assert_rel(got, want, tol, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, "%s: max err %g > %g x %g" % (what, err, tol,
                                                            scale)


# (step, Tm, n_layers, C, H): steps around the 256-frame cache blocks,
# memory held in VMEM (Tm=256) and streamed (Tm=512 and 768), D=96 and D=384
CASES = [(s, tm, 2, 48, 4) for tm in (256, 512)
         for s in (0, 1, 255, 256, 300)] + [(257, 256, 1, 768, 8)] + \
    [(300, 256, 1, 768, 2),      # D=384, the flagship width with 2 heads
     (40, 768, 1, 64, 2)]        # a memory three TPU blocks long


@pytest.mark.parametrize("step,t_mem,n_layers,c,heads", CASES,
                         ids=["step%d_tm%d_c%d" % (s, tm, c)
                              for s, tm, _, c, _ in CASES])
def test_frame_step_matches_pallas_interpret(step, t_mem, n_layers, c,
                                             heads):
    b, t_cap = 2, 512
    x, w, ck, cv, mk, mv, bias = step_inputs(step + t_mem, n_layers, b, c,
                                             t_cap, t_mem, [t_mem - 37, 5])
    want = jax_decode.decoder_frame_step(
        jnp.asarray(x), step, {k: jnp.asarray(v) for k, v in w.items()},
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(mk), jnp.asarray(mv),
        jnp.asarray(bias), num_heads=heads, interpret=True)
    t = torch.from_numpy
    got = decode.decoder_frame_step(
        t(x), step, {k: t(v) for k, v in w.items()}, t(ck), t(cv), t(mk),
        t(mv), t(bias), num_heads=heads)
    x_out, align, k_new, v_new = (np.asarray(a) for a in want)
    assert_rel(got[0].numpy(), x_out, 1e-5, "x_out")
    assert_rel(got[2].numpy(), k_new, 1e-5, "k_new")
    assert_rel(got[3].numpy(), v_new, 1e-5, "v_new")
    assert got[1].shape == (n_layers, b, t_mem, heads)
    np.testing.assert_allclose(got[1].numpy(), align, rtol=0, atol=1e-6)
    # padded memory columns get exactly no weight
    assert float(got[1][:, 1, 5:].abs().max()) == 0.0


# (step, Tm, n_layers, C, H) in bf16: past the first cache block, with the
# memory held (Tm=256) and streamed (Tm=512), and D=96
BF16_CASES = [(300, 256, 2, 48, 4), (257, 512, 2, 48, 4),
              (300, 256, 1, 768, 8)]


@pytest.mark.parametrize("step,t_mem,n_layers,c,heads", BF16_CASES,
                         ids=["step%d_tm%d_c%d" % (s, tm, c)
                              for s, tm, _, c, _ in BF16_CASES])
def test_bf16_rounding_points_match_pallas_interpret(step, t_mem, n_layers,
                                                     c, heads):
    """bf16 weights, caches and memory: the plain version's rounding points
    against the TPU kernel's.  Only the fp32 summation orders differ, so
    x_out agrees to ~3e-7 of its largest magnitude and the weights to ~6e-8
    (measured); k_new/v_new are bf16 roundings of fp32 values that agree as
    closely, so at most a rare element sits one ulp away.  A rounding point
    missed on either side moves x_out and the weights by 1e-3 or more."""
    b, t_cap = 2, 512
    x, w, ck, cv, mk, mv, bias = step_inputs(7 * step + c, n_layers, b, c,
                                             t_cap, t_mem, [t_mem - 37, 5])
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tw = {k: torch.from_numpy(v) if k == "lns" else bf(v)
          for k, v in w.items()}
    tc = [bf(a) for a in (ck, cv, mk, mv)]
    jx = lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    want = jax_decode.decoder_frame_step(
        jnp.asarray(x), step, {k: jx(v) for k, v in tw.items()},
        *(jx(t) for t in tc), jnp.asarray(bias), num_heads=heads,
        interpret=True)
    got = decode.decoder_frame_step(torch.from_numpy(x), step, tw, *tc,
                                    torch.from_numpy(bias), num_heads=heads)
    x_out, align, k_new, v_new = (np.asarray(a.astype(jnp.float32))
                                  for a in want)
    assert got[2].dtype == got[3].dtype == torch.bfloat16
    assert_rel(got[0].numpy(), x_out, 1e-5, "x_out")
    for name, g, wt in (("k_new", got[2], k_new), ("v_new", got[3], v_new)):
        g = g.float().numpy()
        off = g != wt
        assert off.mean() <= 0.01, "%s: %d elements differ" % (name,
                                                               off.sum())
        assert np.all(np.abs(g - wt) <= 2.0 ** -7 * np.abs(wt)), name
    d = np.abs(got[1].numpy() - align)
    assert d.max() <= 1e-6, "align: max err %g" % d.max()
    assert d.sum(2).max() <= 1e-5, "align: row L1 %g" % d.sum(2).max()
    assert float(got[1][:, 1, 5:].abs().max()) == 0.0


def test_stacking_and_memory_projection_match_jax():
    variables = jax_variables(11)
    model = port_model(variables)
    w = decode.stack_decoder_params(model.decoder.decoder, torch.float32)
    want = jax_decode.stack_decoder_params(
        variables["params"]["decoder"]["decoder"], HP.n_decoder_layer)
    # the JAX stacking, plus the kernel's tiled copy of it
    assert sorted(w) == sorted(list(want) + ["tiles"])
    back = decode.unpack_decoder_weights(w["tiles"], HP.decoder_hidden,
                                         w["w_ffn1"].shape[-1])
    for name in back:
        assert torch.equal(back[name], w[name]), name
    for name in want:
        assert w[name].shape == want[name].shape, name
        np.testing.assert_array_equal(w[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
        assert w[name].is_contiguous()
    enc = np.random.RandomState(2).randn(3, 10, HP.decoder_hidden).astype(
        np.float32)
    got = decode.project_memory(torch.from_numpy(enc), w["w_kv"],
                                torch.float32)
    ref = jax_decode.project_memory(jnp.asarray(enc), want["w_kv"],
                                    jnp.float32)
    for g, r in zip(got, ref):
        assert g.shape == (HP.n_decoder_layer, 3, 256, HP.decoder_hidden)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)
    assert decode.padded_cap(24) == jax_decode.padded_cap(24) == 256
    assert decode.padded_cap(257) == 512


def jax_fused(variables, batch, monkeypatch, **kw):
    monkeypatch.setenv("FSTTS_PALLAS_INTERPRET", "1")
    hp = jax_cfg(use_pallas_decode=True)
    return jax_synthesize_batch(JaxByteToMel(hp), variables, batch, hp,
                                deterministic=True, max_frames=24, **kw)


@pytest.fixture
def count_frame_steps(monkeypatch):
    """Counts the fused steps ``synthesize_batch`` takes (the kernel's own
    ``launches`` counts CUDA launches only)."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[1])
        return FRAME_STEP(*args, **kw)
    monkeypatch.setattr(decode, "decoder_frame_step", spy)
    return calls


@pytest.mark.parametrize("stop_seed", [0, 7], ids=["to_cap",
                                                   "mixed_stops"])
def test_fused_synthesis_matches_jax_fused(stop_seed, monkeypatch,
                                           count_frame_steps):
    variables = with_stop_head(jax_variables(7), stop_seed)
    batch = input_batch()
    want = jax_fused(variables, batch, monkeypatch)
    got = synthesize_batch(port_model(variables), batch, FUSED,
                           deterministic=True, max_frames=24)
    assert got["generated_lengths"] == want["generated_lengths"]
    assert got["mel_pre"].shape == want["mel_pre"].shape
    np.testing.assert_allclose(got["mel_pre"], want["mel_pre"], atol=1e-4)
    np.testing.assert_allclose(got["mel_aft"], want["mel_aft"], atol=1e-4)
    for w, g in zip(want["alignments"]["encdec"],
                    got["alignments"]["encdec"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert count_frame_steps == list(range(len(count_frame_steps)))
    assert len(count_frame_steps) >= got["mel_pre"].shape[1]
    assert FRAME_STEP.launches == 0   # no CUDA tensors here


def test_fused_synthesis_matches_the_eager_path(count_frame_steps):
    model = port_model(with_stop_head(jax_variables(7), 7))
    batch = input_batch()
    eager = synthesize_batch(model, batch, HP, deterministic=True,
                             max_frames=24)
    assert not count_frame_steps
    fused = synthesize_batch(model, batch, FUSED, deterministic=True,
                             max_frames=24)
    assert count_frame_steps
    assert fused["generated_lengths"] == eager["generated_lengths"]
    np.testing.assert_allclose(fused["mel_pre"], eager["mel_pre"],
                               atol=1e-4)
    np.testing.assert_allclose(fused["mel_aft"], eager["mel_aft"],
                               atol=1e-4)
    for e, f in zip(eager["alignments"]["encdec"],
                    fused["alignments"]["encdec"]):
        np.testing.assert_allclose(f, e, atol=1e-5)


def test_fused_synthesis_respects_padding_rows():
    """Lattice row padding must not change the real rows (the JAX
    package's tests/test_pallas_decode.py padding test)."""
    model = port_model(with_stop_head(jax_variables(7), 7))
    b3 = input_batch(b=3)
    b2 = {k: v[:2] for k, v in b3.items()}
    out2 = synthesize_batch(model, b2, FUSED, deterministic=True,
                            max_frames=24)
    out3 = synthesize_batch(model, b3, FUSED, deterministic=True,
                            max_frames=24)
    n = min(out2["mel_pre"].shape[1], out3["mel_pre"].shape[1])
    for i in range(2):
        gl = min(out2["generated_lengths"][i], n)
        np.testing.assert_allclose(out2["mel_pre"][i][:gl],
                                   out3["mel_pre"][i][:gl], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("kw", [dict(deterministic=False),
                                dict(deterministic=True,
                                     collect_self_alignments=True)],
                         ids=["dropout_on", "self_alignments"])
def test_dispatch_declines_the_fused_step(kw, count_frame_steps):
    model = port_model(jax_variables(7))
    out = synthesize_batch(model, input_batch(b=2), FUSED, max_frames=6,
                           generator=torch.Generator().manual_seed(0), **kw)
    assert np.isfinite(out["mel_pre"]).all()
    assert not count_frame_steps
    assert FRAME_STEP.launches == 0


@pytest.mark.parametrize("use_fused", [False, True],
                         ids=["eager", "fused_flag_declines"])
def test_self_alignments_match_jax(use_fused, count_frame_steps):
    variables = with_stop_head(jax_variables(7), 7)
    batch = input_batch()
    hp = jax_cfg(use_pallas_decode=use_fused)
    want = jax_synthesize_batch(JaxByteToMel(hp), variables, batch, hp,
                                deterministic=True, max_frames=24,
                                collect_self_alignments=True)
    got = synthesize_batch(port_model(variables), batch,
                           HP.replace(use_pallas_decode=use_fused),
                           deterministic=True, max_frames=24,
                           collect_self_alignments=True)
    assert not count_frame_steps
    assert got["generated_lengths"] == want["generated_lengths"]
    n = got["mel_pre"].shape[1]
    assert len(got["alignments"]["self"]) == HP.n_decoder_layer
    for w, g in zip(want["alignments"]["self"], got["alignments"]["self"]):
        assert g.shape == w.shape == (4, HP.n_attention_head, n, n)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    # query frame t attends to frames <= t only, with weights summing to 1
    s = got["alignments"]["self"][0]
    assert np.all(np.triu(np.ones((n, n)), 1).T[None, None] * s == 0)
    np.testing.assert_allclose(s.sum(2), 1.0, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, ck, cv, mk, mv, bias = (
        step_inputs(0, 1, 2, 16, 256, 256, [256, 10]))
    t = torch.from_numpy
    args = [t(x), 3, {k: t(v) for k, v in w.items()}, t(ck), t(cv), t(mk),
            t(mv), t(bias)]
    with pytest.raises(ValueError, match="outside the cache"):
        decode.decoder_frame_step(*args[:1], 256, *args[2:], num_heads=2)
    with pytest.raises(ValueError, match="mem_bias"):
        decode.decoder_frame_step(*args[:7], t(bias[:, :100]), num_heads=2)
    with pytest.raises(ValueError, match="heads"):
        decode.decoder_frame_step(*args, num_heads=3)
    with pytest.raises(ValueError, match="on CPU or CUDA"):
        decode.decoder_frame_step(
            args[0].to("meta"), 3, {k: v.to("meta") for k, v in
                                    args[2].items()},
            *(a.to("meta") for a in args[3:]), num_heads=2)
    got = decode.decoder_frame_step(*args, num_heads=2)
    assert [tuple(g.shape) for g in got] == [(2, 16), (1, 2, 256, 2),
                                             (1, 2, 16), (1, 2, 16)]


@pytest.mark.parametrize("c,f,dtype", [(768, 3072, torch.bfloat16),
                                       (48, 200, torch.float32),
                                       (40, 136, torch.bfloat16)],
                         ids=["flagship_bf16", "c48_fp32", "ragged_bf16"])
def test_weight_tiles_cover_every_weight_once_and_round_trip(c, f, dtype):
    """``pack_decoder_weights``: every weight lands in exactly one place of
    the tiled copy (the rest is zero padding), in the mma A-fragment order
    the kernel reads, and unpacks to the stacked matrices."""
    n_layers = 2
    shapes = {"w_qkv": (c, 3 * c), "w_out": (c, c), "w_q": (c, c),
              "w_xout": (c, c), "w_ffn1": (c, f), "w_ffn2": (f, c)}
    # distinct values (exact in bf16 below 256 per matrix is not needed:
    # positions are checked through a numbered copy in fp32)
    w, numbered, start = {}, {}, 1
    for name, (k, n) in shapes.items():
        w[name] = torch.randn(n_layers, k, n).to(dtype)
        numbered[name] = (torch.arange(n_layers * k * n, dtype=torch.float64)
                          + start).reshape(n_layers, k, n)
        start += n_layers * k * n
    tiles = decode.pack_decoder_weights(w)
    assert tiles.dtype == dtype and tiles.is_contiguous()
    assert tiles.shape == (n_layers, decode.layer_elems(c, f))
    back = decode.unpack_decoder_weights(tiles, c, f)
    for name in shapes:
        assert torch.equal(back[name], w[name]), name
    ids = decode.pack_decoder_weights(numbered)
    got = np.sort(ids[ids > 0].numpy())
    np.testing.assert_array_equal(got, np.arange(1, start))
    # fragment order: lane 4g + t's first register holds W[k0 + 2t, n0 + g]
    # and W[k0 + 2t + 1, n0 + g] of the first tile of the first unit
    first = ids[0, :256].reshape(32, 8)
    m = numbered["w_qkv"][0]
    for lane in (0, 5, 31):
        g, t = lane // 4, lane % 4
        assert first[lane, 0] == m[2 * t, g]
        assert first[lane, 1] == m[2 * t + 1, g]
        assert first[lane, 2] == m[2 * t, g + 8]
        assert first[lane, 5] == m[2 * t + 9, g]
        assert first[lane, 7] == m[2 * t + 9, g + 8]


@pytest.mark.parametrize("c,f,elt,grid", [(768, 3072, 2, 132),
                                          (768, 3072, 4, 132),
                                          (128, 512, 2, 132),
                                          (40, 136, 2, 7)])
def test_schedule_gives_every_unit_one_owner_and_balances_bytes(c, f, elt,
                                                                grid):
    """``decoder_schedule``: each 16-column unit of each stage's product
    has exactly one block, a block's entries run stage by stage, and no
    block streams more than one unit above the mean of a layer's bytes."""
    offsets, entries = decode.decoder_schedule(c, f, elt, grid)
    assert offsets.shape == (grid + 1,) and offsets[0] == 0
    assert offsets[-1] == len(entries)
    shapes = decode._stage_shapes(c, f)
    want = sorted(s << 16 | u for s, (_, n) in enumerate(shapes)
                  for u in range((n + 15) // 16))
    assert sorted(entries.tolist()) == want
    cost = [((k + 15) // 16 * 16) * 16 * elt + decode._UNIT_COST
            for k, _ in shapes]
    loads = []
    for g in range(grid):
        mine = entries[offsets[g]:offsets[g + 1]].tolist()
        assert mine == sorted(mine)
        loads.append(sum(cost[e >> 16] for e in mine))
    assert max(loads) - sum(loads) / grid <= max(cost)
    # the flagship's layer, 16.5 MB of bf16 weights, on 132 SMs
    if (c, f, elt, grid) == (768, 3072, 2, 132):
        assert decode.layer_elems(c, f) * 2 == 16515072
        assert max(loads) <= 1.15 * sum(loads) / grid


# --- the fused frame loop: the kernel launch, then the chain of small ops
# that a CUDA graph replays on a card (run eagerly here) ---

@torch.no_grad()
def per_frame_fused(model, batch, hp, cap):
    """The fused path as one Python step a frame, indexed by the host's
    step: mel_pre, mel_aft, lengths and cross-attention weights [L, B, H,
    T_dec, T_enc] of every row, as numpy."""
    dev, dtype = model.device, model.dtype
    inputs, lengths, spk, lvec = (torch.from_numpy(a).to(dev) for a in
                                  syn.prepare_decode_inputs(batch, hp))
    b, t_in = inputs.shape
    with syn.matmul_weights_in(model, dtype):
        dec = model.decoder.decoder
        enc = model.encoder(inputs, lengths, spk, lvec, deterministic=True)
        w = decode.stack_decoder_params(dec, dtype)
        mem_k, mem_v = decode.project_memory(enc, w.pop("w_kv"), dtype)
        bias = F.pad(syn.padding_bias(syn.length_mask(lengths, t_in))
                     [:, 0, 0, :], (0, mem_k.shape[2] - t_in),
                     value=syn.NEG_INF)
        cache_k = torch.zeros(hp.n_decoder_layer, b, decode.padded_cap(cap),
                              hp.decoder_hidden, dtype=dtype)
        cache_v = torch.zeros_like(cache_k)
        pe = syn.sinusoid_position_encoding(cap, hp.decoder_hidden)
        mels = torch.zeros(b, cap, hp.num_mels)
        finished = torch.zeros(b, dtype=torch.bool)
        lengths_out = torch.ones(b, dtype=torch.int32)
        prev_mel = torch.zeros(b, hp.num_mels)
        aligns, steps_run = [], 0
        for step in range(cap):
            if step % 16 == 0 and step and bool(finished.all()):
                break
            x = model.decoder_inputs(prev_mel, finished)
            x = x + pe[step].to(x.dtype) * dec.pe_scale.to(x.dtype)
            x_out, align, k_new, v_new = FRAME_STEP(
                x.float(), step, w, cache_k, cache_v, mem_k, mem_v, bias,
                num_heads=hp.n_attention_head)
            cache_k[:, :, step] = k_new
            cache_v[:, :, step] = v_new
            mel, stop = model.decoder_outputs(
                dec.output_layer_norm(x_out.to(dtype)))
            mels[:, step] = mel
            aligns.append(align.permute(0, 1, 3, 2)[..., :t_in])
            finished = finished | (stop > 0)
            lengths_out = torch.where(finished, lengths_out, lengths_out + 1)
            prev_mel = mel
            steps_run = step + 1
        n = min(int(lengths_out.max()), steps_run)
        mel_aft = mels + model.postnet_residual(mels, lengths_out)
    return (mels[:, :n].numpy(), mel_aft[:, :n].numpy(), lengths_out.numpy(),
            torch.stack(aligns[:n], dim=3).numpy())


@pytest.mark.parametrize("collect", [True, False],
                         ids=["alignments", "no_alignments"])
@pytest.mark.parametrize("cap", [24, 37])
def test_fused_loop_matches_the_per_frame_code(cap, collect):
    """The loop of kernel launches and chains indexed by the device step
    gives the per-frame code's outputs bit for bit, at caps that are not
    multiples of the stop check's 16 frames, with rows that stop at
    different frames."""
    model = port_model(with_stop_head(jax_variables(7), 7))
    batch = input_batch()
    got = synthesize_batch(model, batch, FUSED, deterministic=True,
                           max_frames=cap, collect_alignments=collect)
    mel_pre, mel_aft, lengths, aligns = per_frame_fused(model, batch, FUSED,
                                                        cap)
    b, t_in = batch["inputs"].shape
    assert len(set(got["generated_lengths"])) > 1   # rows stop apart
    assert got["generated_lengths"] == list(lengths[:b])
    np.testing.assert_array_equal(got["mel_pre"], mel_pre[:b])
    np.testing.assert_array_equal(got["mel_aft"], mel_aft[:b])
    if not collect:
        assert got["alignments"]["encdec"] is None
        return
    for layer, a in enumerate(got["alignments"]["encdec"]):
        np.testing.assert_array_equal(
            a, aligns[layer, :b, ..., :t_in].transpose(0, 1, 3, 2))


def test_host_step_and_device_step_agree_at_every_frame(monkeypatch):
    seen = []
    launch = syn._FusedFrames.launch

    def spy(fr, step):
        seen.append((step, int(fr.step_t)))
        return launch(fr, step)
    monkeypatch.setattr(syn._FusedFrames, "launch", spy)
    model = port_model(with_stop_head(jax_variables(7), 0, bias=-1e4))
    synthesize_batch(model, input_batch(), FUSED, deterministic=True,
                     max_frames=37)
    assert [s for s, _ in seen] == list(range(37))
    assert all(step == step_t for step, step_t in seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_frame_step_out_takes_the_outputs(dtype):
    """``decoder_frame_step(..., out=FrameStepOut(...))`` writes the
    call's outputs into ``out``'s buffers, equal to the call without it,
    and refuses other inputs and steps outside the cache."""
    x, w, ck, cv, mk, mv, bias = step_inputs(5, 2, 2, 48, 256, 256,
                                             [200, 9])
    t = lambda a: torch.from_numpy(a).to(dtype)
    w = {k: torch.from_numpy(v) if k == "lns" else t(v)
         for k, v in w.items()}
    args = [torch.from_numpy(x), w, t(ck), t(cv), t(mk), t(mv),
            torch.from_numpy(bias)]
    out = decode.FrameStepOut(*args, num_heads=4)
    for step in (0, 37, 255):
        want = decode.decoder_frame_step(args[0], step, *args[1:],
                                         num_heads=4)
        got = decode.decoder_frame_step(args[0], step, *args[1:],
                                        num_heads=4, out=out)
        assert all(g is o for g, o in zip(got, out.tensors))
        for g, wt in zip(got, want):
            assert g.dtype == wt.dtype and torch.equal(g, wt)
    with pytest.raises(ValueError, match="outside the cache"):
        decode.decoder_frame_step(args[0], 256, *args[1:], num_heads=4,
                                  out=out)
    with pytest.raises(ValueError, match="other inputs"):
        decode.decoder_frame_step(args[0].clone(), 3, *args[1:],
                                  num_heads=4, out=out)
    with pytest.raises(ValueError, match="mem_bias"):
        decode.FrameStepOut(*args[:6], args[6][:, :100], num_heads=4)


def test_cpu_frames_count_as_eager():
    """On the CPU every fused frame's chain runs eagerly: the counters say
    so, and the eager path counts neither."""
    model = port_model(with_stop_head(jax_variables(7), 0, bias=-1e4))
    counters = []
    for hp in (FUSED, HP):
        tracing.reset()
        synthesize_batch(model, input_batch(), hp, deterministic=True,
                         max_frames=21)
        counters.append(tracing.windows()[-1]["counters"])
    fused, eager = counters
    assert fused["synth.frame_steps"] == fused["synth.eager_frames"] == 21
    assert fused["synth.graph_frames"] == 0
    assert eager["synth.frame_steps"] == 21
    assert "synth.eager_frames" not in eager
    assert "synth.graph_frames" not in eager


def _graph_frame_share(cell):
    path = ROOT / "gpubench" / "metrics" / ("graph_frame_share.%s.py" % cell)
    spec = importlib.util.spec_from_file_location(
        "graph_frame_share_" + cell, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.value


def _window(profiled, counters):
    return {"index": 0, "profiled": profiled, "spans": {},
            "counters": counters}


@pytest.mark.parametrize("cell", ["synth", "utt"])
def test_graph_frame_share_reads_the_frame_counters(cell):
    """The benchmark's ``graph_frame_share.<cell>``: replayed frames over
    all fused frames in the unprofiled window after the trace; None where
    there is no such window or, as in a program without the counters,
    nothing to divide."""
    value = _graph_frame_share(cell)
    traced = _window(True, {"synth.graph_frames": 1,
                            "synth.eager_frames": 9})
    after = _window(False, {"synth.graph_frames": 995,
                            "synth.eager_frames": 5,
                            "synth.frame_steps": 1000})
    assert value([_window(False, {}), traced, after]) == \
        pytest.approx(99.5, rel=1e-12)
    assert value([after]) is None                      # never profiled
    assert value([after, traced]) is None              # nothing after it
    assert value([traced, _window(False, {"synth.frame_steps": 8})]) is None
    assert value([traced, _window(False, {"synth.eager_frames": 4})]) == 0.0
