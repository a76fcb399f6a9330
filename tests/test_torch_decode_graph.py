"""The fused frame loop on a card (marked ``card``; each test skips without
one): the chain of small ops between two decode kernels, replayed from a
CUDA graph after frame 0, against the same chain run eagerly every frame on
the card, bit for bit, at the flagship's bulk-synthesis shape (B=32, C=768)
and the single-voice shape (B=1 padded to 8, C=512), at caps that are not
multiples of the stop check's 16 frames.

Imports nothing of JAX.  On a card, without the JAX conftest:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_decode_graph.py``.
"""

import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch.config import default_config
from few_shot_transformer_tts_torch.infer import synthesize as syn
from few_shot_transformer_tts_torch.models import ByteToMel
from few_shot_transformer_tts_torch.models.tacotron import init_weights_
from few_shot_transformer_tts_torch.utils import tracing

# (name, config, rows, text bytes, cap)
SHAPES = [
    ("flagship", {}, 32, 160, 45),
    ("ljspeech", dict(multi_speaker=False, multi_lingual=False,
                      decoder_hidden=512), 1, 60, 125)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def batch_of(hp, rows, t_in, seed):
    rng = np.random.RandomState(seed)
    batch = dict(inputs=rng.randint(3, 255, (rows, t_in)).astype(np.int32),
                 input_lengths=rng.randint(t_in // 2, t_in + 1,
                                           rows).astype(np.int32))
    if hp.multi_speaker:
        batch["input_spk_ids"] = rng.randint(
            0, hp.max_num_speaker, rows).astype(np.int32)
    if hp.multi_lingual:
        batch["input_language_vecs"] = np.eye(
            hp.max_num_language, dtype=np.float32)[
            rng.randint(0, hp.max_num_language, rows)]
    return batch


@torch.no_grad()
def graphed_and_eager(model, hp, batch, cap):
    """Two fused loops over the same inputs, alignments on: ``_fused_loop``
    (a graph of the chain on a card), and the same frames with every chain
    run eagerly.  Returns (frames run, graphed state, eager state)."""
    args = [torch.from_numpy(a).to(model.device)
            for a in syn.prepare_decode_inputs(batch, hp)]
    bias = syn.padding_bias(syn.length_mask(args[1], args[0].shape[1]))
    with syn.matmul_weights_in(model, model.dtype):
        graphed = syn._FusedFrames(model, args, bias, cap, True)
        steps = syn._fused_loop(graphed, cap)
        eager = syn._FusedFrames(model, args, bias, cap, True)
        for step in range(steps):
            eager.chain(eager.launch(step))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return steps, graphed, eager


STATE = ("mels", "target_lengths", "finished", "prev_mel", "cache_k",
         "cache_v", "aligns", "x", "step_t")


@pytest.mark.card
@pytest.mark.parametrize("name,overrides,rows,t_in,cap", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_graphed_frames_equal_the_eager_chain(card, name, overrides, rows,
                                              t_in, cap):
    hp = default_config(**overrides)
    model = init_weights_(ByteToMel(hp, device=card), 11).eval()
    tracing.reset()
    steps, graphed, eager = graphed_and_eager(
        model, hp, batch_of(hp, rows, t_in, 5), cap)
    counters = tracing.windows()[-1]["counters"]
    assert counters["synth.eager_frames"] == 1
    assert counters["synth.graph_frames"] == steps - 1 > 0
    assert int(graphed.step_t) == steps
    for field in STATE:
        g, e = getattr(graphed, field), getattr(eager, field)
        assert torch.equal(g, e), "%s: max diff %g" % (
            field, (g.double() - e.double()).abs().max())


def test_the_comparison_runs_on_the_cpu():
    """The same comparison at a small width on the CPU, where every chain
    runs eagerly: the loop and the hand-driven frames agree, and every
    frame counts as eager."""
    from few_shot_transformer_tts_torch.config import small_test_config
    hp = small_test_config()
    model = init_weights_(ByteToMel(hp, device="cpu"), 11).eval()
    tracing.reset()
    steps, graphed, eager = graphed_and_eager(model, hp,
                                              batch_of(hp, 3, 12, 5), 21)
    counters = tracing.windows()[-1]["counters"]
    assert counters["synth.eager_frames"] == steps > 16
    assert counters["synth.graph_frames"] == 0
    for field in STATE:
        assert torch.equal(getattr(graphed, field), getattr(eager, field))


@pytest.mark.card
def test_an_entry_that_returns_other_tensors_runs_every_chain_eagerly(
        card, monkeypatch):
    """The graph reads the buffers the kernel entry returned when it was
    captured; a wrapped entry that returns copies gets every chain run
    eagerly on its own outputs instead, with the same result."""
    from few_shot_transformer_tts_torch.ops import decode
    real = decode.decoder_frame_step

    def copies(*a, **k):
        return tuple(t.clone() for t in real(*a, **k))
    # the entry counts its launches on its module-level name
    copies.launches = 0
    monkeypatch.setattr(decode, "decoder_frame_step", copies)
    _, overrides, rows, t_in, _ = SHAPES[1]
    hp = default_config(**overrides)
    model = init_weights_(ByteToMel(hp, device=card), 11).eval()
    tracing.reset()
    steps, copied, eager = graphed_and_eager(
        model, hp, batch_of(hp, rows, t_in, 5), 37)
    counters = tracing.windows()[-1]["counters"]
    assert counters["synth.eager_frames"] == steps > 1
    assert counters["synth.graph_frames"] == 0
    for field in STATE:
        assert torch.equal(getattr(copied, field), getattr(eager, field))


@pytest.mark.card
def test_later_calls_allocate_nothing_more(card):
    """Every call captures on the same side stream of its thread, so a
    later call leaves no more memory allocated than the first (a stream a
    call would hold a cuBLAS workspace each)."""
    from few_shot_transformer_tts_torch.infer import synthesize_batch
    _, overrides, rows, t_in, _ = SHAPES[1]
    hp = default_config(use_pallas_decode=True, **overrides)
    model = init_weights_(ByteToMel(hp, device=card), 11).eval()
    batch = batch_of(hp, rows, t_in, 5)
    allocated = []
    for _ in range(4):
        synthesize_batch(model, batch, hp, deterministic=True,
                         collect_alignments=False, max_frames=40)
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    assert allocated[1:] == allocated[:1] * 3, allocated
