"""F5-TTS in the port (``models/f5tts.py``, ``infer/flow.py``) against the
plain float32 reference ``gpubench/reference/f5tts.py`` on the CPU, at a
tiny width: dim 64, depth 2, 4 heads, text 32 wide with one ConvNeXt-V2
block, 20 mels, fp32.  Both hold the same seeded weights."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from few_shot_transformer_tts_torch.config import Config, default_config
from few_shot_transformer_tts_torch.infer import synthesize_batch
from few_shot_transformer_tts_torch.infer import flow
from few_shot_transformer_tts_torch.models.f5tts import F5TTS
from gpubench.reference import f5tts as R

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(model="f5tts", dit_dim=64, dit_depth=2, dit_heads=4,
            text_dim=32, text_conv_layers=1, num_mels=20,
            use_bfloat16=False, use_pallas_attention=False)
TEXT = b"the quick brown fox jumps over"
PROMPT_BYTES = 9


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def tiny():
    hp = Config(**TINY)
    P = R.make_weights(hp, 2 ** 31 + 77, "cpu")
    model = F5TTS(hp, device="cpu")
    model.load_state_dict(P, strict=True)
    return hp, P, model.eval()


def _row(seed, frames=14, text=TEXT):
    rng = np.random.RandomState(seed)
    prompt = rng.uniform(-10, 2, (frames, 20)).astype(np.float32)
    return prompt, list(text)


def _batch(rows, hp, gen_seed=5):
    """A sampler batch of rows (prompt, ids) and the noise the reference
    starts each row from."""
    g = torch.Generator().manual_seed(gen_seed)
    durs = [R.duration(len(p), PROMPT_BYTES, len(ids) - PROMPT_BYTES,
                       len(ids), 10 ** 6) for p, ids in rows]
    t = max(durs)
    noise = torch.zeros(len(rows), t, hp.num_mels)
    for i, n in enumerate(durs):
        noise[i, :n] = torch.randn(n, hp.num_mels, generator=g)
    width = max(len(ids) for _, ids in rows)
    inputs = np.full((len(rows), width), -1, np.int64)
    for i, (_, ids) in enumerate(rows):
        inputs[i, :len(ids)] = ids
    return {"inputs": inputs, "input_lengths": [len(ids) for _, ids in rows],
            "prompt_bytes": [PROMPT_BYTES] * len(rows),
            "prompt_mels": [p for p, _ in rows], "noise": noise}, durs


@pytest.mark.parametrize("kind", ["conditional", "unconditional", "cfg"])
def test_velocity_matches_the_reference(tiny, kind):
    hp, P, model = tiny
    prompt, ids = _row(1)
    t = 40
    x = torch.randn(t, hp.num_mels, generator=torch.Generator().manual_seed(3))
    cond = torch.zeros(t, hp.num_mels)
    cond[:len(prompt)] = torch.from_numpy(prompt)
    ids_t = torch.tensor([ids])
    lengths = torch.tensor([t])
    with torch.no_grad():
        def prog(drop):
            return model(x[None], cond[None], ids_t, 0.37, lengths, drop,
                         drop)[0]
        if kind == "cfg":
            got = prog(False) + flow.CFG_STRENGTH * (prog(False) - prog(True))
            want = R.cfg_velocity(P, hp, x, cond, ids, 0.37)
        else:
            drop = kind == "unconditional"
            got = prog(drop)
            want = R.velocity(P, hp, x, cond, ids, 0.37, drop)
    assert _rel(got, want) < 1e-5


def test_rope_turns_the_first_head_only():
    # F5TTS_Base's pe_attn_head 1: the first 64 packed channels turn
    from few_shot_transformer_tts_torch.models.f5tts import (apply_rope,
                                                             rope_tables)
    x = torch.randn(2, 9, 4 * 8, generator=torch.Generator().manual_seed(5))
    got = apply_rope(x.clone(), rope_tables(9, 8, "cpu"))
    assert torch.equal(got[..., 8:], x[..., 8:])
    assert not torch.allclose(got[..., 1:, :8], x[..., 1:, :8])
    for row in range(2):
        assert _rel(got[row], R._rope(x[row], 8)) < 1e-6


def test_the_whole_sampler_matches_the_reference(tiny):
    hp, P, model = tiny
    rows = [_row(2)]
    batch, durs = _batch(rows, hp)
    out = synthesize_batch(model, batch, hp)
    want, _ = R.sample(P, hp, batch["noise"][0, :durs[0]],
                       torch.from_numpy(rows[0][0]), rows[0][1])
    got = out["mel_aft"][0][:durs[0]]
    assert out["generated_lengths"] == durs
    assert np.array_equal(out["mel_pre"], out["mel_aft"])
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("nfe,sway", [(32, -1.0), (32, 0.0), (8, 0.5)])
def test_sway_schedule_is_its_closed_form(nfe, sway):
    got = flow.flow_times(nfe, sway).double().numpy()
    t = np.arange(nfe + 1) / nfe
    want = t + sway * (np.cos(np.pi / 2 * t) - 1 + t)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(R.flow_times(nfe, sway), want, atol=1e-6)
    assert got[0] == 0.0 and abs(got[-1] - 1.0) < 1e-6
    assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("prompt_frames,prompt_bytes,target_bytes,want", [
    (282, 70, 24, 282 + math.floor(282 / 70 * 24)),
    (938, 141, 180, 938 + math.floor(938 / 141 * 180)),
    (100, 3, 1, 133),
    (10, 5, 0, 10)])
def test_duration_rule(prompt_frames, prompt_bytes, target_bytes, want):
    assert flow.f5_duration(prompt_frames, prompt_bytes, target_bytes) == \
        want
    # the sampler and the reference: at least one frame past the prompt
    # and the text, at most the cap
    total = prompt_bytes + target_bytes
    floor = max(prompt_frames, total) + 1
    assert R.duration(prompt_frames, prompt_bytes, target_bytes, total,
                      10 ** 6) == max(want, floor)
    assert R.duration(prompt_frames, prompt_bytes, target_bytes, total,
                      50) == min(max(want, floor), 50)
    hp = Config(**TINY)
    batch = {"inputs": [[97] * total], "input_lengths": [total],
             "prompt_bytes": [prompt_bytes],
             "prompt_mels": [np.zeros((prompt_frames, 20), np.float32)]}
    _, dur, plen, _ = flow.f5_batch_inputs(batch, hp, 10 ** 6)
    assert int(dur[0]) == max(want, floor) and int(plen[0]) == prompt_frames


def test_prompt_frames_are_the_prompt(tiny):
    hp, _, model = tiny
    rows = [_row(3, frames=11), _row(4, frames=17)]
    batch, _ = _batch(rows, hp)
    out = synthesize_batch(model, batch, hp)
    for i, (prompt, _) in enumerate(rows):
        assert np.array_equal(out["mel_aft"][i][:len(prompt)], prompt)
    assert out["prompt_lengths"] == [11, 17]


@pytest.mark.parametrize("others", [1, 4, 9])
def test_a_padded_row_equals_the_row_alone(tiny, others):
    # the short row packed beside 1, 4 or 9 longer ones (``Packing``)
    hp, _, model = tiny
    rows = [_row(5, frames=9, text=TEXT[:20])] + \
        [_row(6 + k, frames=23 - k) for k in range(others)]
    batch, durs = _batch(rows, hp)
    assert durs[0] < min(durs[1:])
    both = synthesize_batch(model, batch, hp)
    alone = synthesize_batch(model, {
        "inputs": batch["inputs"][:1, :20], "input_lengths": [20],
        "prompt_bytes": [PROMPT_BYTES],
        "prompt_mels": batch["prompt_mels"][:1],
        "noise": batch["noise"][:1, :durs[0]]}, hp)
    assert alone["mel_aft"].shape[1] == durs[0]
    np.testing.assert_allclose(both["mel_aft"][0][:durs[0]],
                               alone["mel_aft"][0], rtol=0, atol=1e-5)
    assert not both["mel_aft"][0][durs[0]:].any()


def test_the_unconditional_pass_zeroes_the_prompt_and_fills_the_text(tiny):
    hp, P, model = tiny
    prompt, ids = _row(7)
    t = 30
    x = torch.randn(1, t, hp.num_mels,
                    generator=torch.Generator().manual_seed(9))
    cond = torch.zeros(1, t, hp.num_mels)
    cond[0, :len(prompt)] = torch.from_numpy(prompt)
    lengths = torch.tensor([t])
    with torch.no_grad():
        dropped = model(x, cond, torch.tensor([ids]), 0.5, lengths, True,
                        True)
        explicit = model(x, torch.zeros_like(cond),
                         torch.full((1, len(ids)), -1), 0.5, lengths)
        kept = model(x, cond, torch.tensor([ids]), 0.5, lengths)
    assert torch.equal(dropped, explicit)
    assert _rel(dropped, kept) > 1e-2
    want = R.velocity(P, hp, x[0], torch.zeros(t, hp.num_mels), [], 0.5,
                      False)
    assert _rel(dropped[0], want) < 1e-5


def test_a_bf16_run_fails_the_fp32_tolerance(tiny):
    hp, P, _ = tiny
    bf = F5TTS(hp.replace(use_bfloat16=True), device="cpu")
    bf.load_state_dict(P, strict=True)
    rows = [_row(8)]
    batch, durs = _batch(rows, hp)
    got = synthesize_batch(bf.eval(), batch, bf.hp)["mel_aft"][0][:durs[0]]
    want, _ = R.sample(P, hp, batch["noise"][0, :durs[0]],
                       torch.from_numpy(rows[0][0]), rows[0][1])
    assert _rel(got, want) > 1e-4


def test_the_state_dict_is_the_references_parameter_spec(tiny):
    hp, _, model = tiny
    names = [n for n, _, _ in R.param_spec(hp)]
    assert sorted(model.state_dict()) == sorted(names)
    full = Config(model="f5tts")
    total = sum(int(np.prod(s)) for _, s, _ in R.param_spec(full))
    assert 330e6 < total < 340e6       # F5TTS_Base: 336.8M with its vocab


@pytest.mark.parametrize("spec", [
    "", "num_mels=40,use_bfloat16=False", "use_pallas_decode=True",
    "mesh_model_axis=2,mesh_data_axis=-1", "n_attention_head=2"])
def test_existing_configs_are_byte2speech(spec):
    assert Config().model == "byte2speech"
    assert default_config().parse(spec).model == "byte2speech"


@pytest.mark.parametrize("overrides,match", [
    (dict(model="f5tts", dit_dim=100, dit_heads=16), "dit_heads"),
    (dict(model="f5tts", mesh_model_axis=2), "mesh_model_axis"),
    (dict(model="tacotron2"), "model must be")])
def test_config_rejects(overrides, match):
    with pytest.raises(ValueError, match=match):
        Config(**overrides)


def test_the_cli_writes_a_mel_and_a_wav(tmp_path):
    from few_shot_transformer_tts_torch.synthesize import main
    prompt = tmp_path / "p.npy"
    np.save(prompt, _row(9)[0])
    hparams = ",".join("%s=%s" % kv for kv in TINY.items()) + ",flow_nfe=3"
    out = main(["--device", "cpu", "--hparams", hparams, "--prompt",
                str(prompt), "--prompt_text", "hello there", "--text",
                "how are you", "--output-dir", str(tmp_path / "o")])
    mel = np.load(tmp_path / "o" / "f5tts.npy")
    assert mel.shape == (out["generated_lengths"][0], 20)
    assert np.array_equal(mel[:14], _row(9)[0])
    assert (tmp_path / "o" / "f5tts.wav").stat().st_size > 44


def test_training_f5_is_refused():
    from few_shot_transformer_tts_torch.train.cli import main
    with pytest.raises(ValueError, match="training model=f5tts is not "
                       "ported"):
        main(["--model-dir", "m", "--log-dir", "l", "--data-dir", "d",
              "--hparams", "model=f5tts"])


def test_the_reference_imports_nothing_of_the_port_or_jax():
    tree = ast.parse((ROOT / "gpubench" / "reference" / "f5tts.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "numpy", "torch"}


@pytest.mark.parametrize("lengths,halves", [([5], 1), ([7, 3, 9], 1),
                                             ([7, 3, 9], 2)])
def test_packing_round_trips_the_rows_frames(lengths, halves):
    from few_shot_transformer_tts_torch.models.f5tts import Packing
    t = max(lengths) + 2
    p = Packing(lengths, halves, t, 8, "cpu")
    x = torch.randn(halves * len(lengths), t, 3,
                    generator=torch.Generator().manual_seed(11))
    tokens = p.pack(x)
    assert tokens.shape == (halves * sum(lengths), 3)
    # half h of row i is its frames, back to back after the rows before it
    for h in range(halves):
        for i, (s, n) in enumerate(zip(p.starts, lengths)):
            at = h * p.frames + s
            assert torch.equal(tokens[at:at + n], x[h * len(lengths) + i, :n])
    assert torch.equal(p.unpack(tokens), x * p.mask[..., None])
    assert torch.equal(p.pack(x[:len(lengths)]), tokens[:p.frames])


def test_packed_attention_is_each_rows_own(monkeypatch):
    # one call a row over its halves and its own frames, no mask; equal to
    # the padded call under the key-padding bias at every frame of a row
    from few_shot_transformer_tts_torch.models.f5tts import Packing
    from few_shot_transformer_tts_torch.ops import mha
    lengths, heads, c = [6, 2, 11], 4, 32
    p = Packing(lengths, 2, 11, c // heads, "cpu")
    g = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(2 * p.frames, c, generator=g) for _ in range(3))
    shapes = []
    real = mha.mha_forward

    def spy(q, k, v, bias, *a):
        shapes.append((tuple(q.shape), tuple(k.shape), bias, a[3]))
        return real(q, k, v, bias, *a)
    monkeypatch.setattr(mha, "mha_forward", spy)
    got = p.unpack(p.attend(q, k, v, heads))
    assert shapes == [((2, n, c), (2, n, c), None, False) for n in lengths]
    bias = torch.where(p.mask, 0.0, -1e30)
    want, _ = real(*(p.unpack(a) for a in (q, k, v)), bias, heads, False,
                   (c // heads) ** -0.5, True)
    torch.testing.assert_close(got, want * p.mask[..., None], rtol=1e-5,
                               atol=1e-6)
