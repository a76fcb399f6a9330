"""The port's own copies of the JAX package's host code, held to the
originals on the same inputs: the byte frontend, metadata parsing and eval
filtering, the synthesis-only ``FeederEval`` under each of its options, and
the numpy DSP that writes the ``.wav`` outputs.  These are exact copies, so
the results must be equal (the waveform to float rounding)."""

import numpy as np
import pytest

from few_shot_transformer_tts_tpu.config import default_config as jax_cfg
from few_shot_transformer_tts_tpu.data import FeederEval as JaxFeederEval
from few_shot_transformer_tts_tpu.data import metadata as jax_metadata
from few_shot_transformer_tts_tpu.frontend import text as jax_text
from few_shot_transformer_tts_tpu.ops import dsp as jax_dsp
from few_shot_transformer_tts_torch.config import default_config
from few_shot_transformer_tts_torch.data import FeederEval, metadata
from few_shot_transformer_tts_torch.frontend import text
from few_shot_transformer_tts_torch.ops import dsp

LANGS = {"en-us": 0, "fr-fr": 1, "de-de": 2}
SPEAKERS = {"spk%d" % i: i for i in range(5)}
# small packing budgets so a script of 24 lines packs into several batches
BUDGETS = dict(batch_frame_limit=200, batch_frame_quad_limit=40000)


def _script_lines(n=24, seed=0):
    rng = np.random.RandomState(seed)
    words = ["hello", "world", "bonjour", "été", "straße", "a", "test"]
    lines = []
    for i in range(n):
        spk = "spk%d" % rng.randint(5)
        lang = list(LANGS)[rng.randint(3)]
        txt = " ".join(rng.choice(words, rng.randint(1, 8)))
        frames = 1200 if i == 5 else rng.randint(50, 900)  # row 5: too long
        lines.append("%s_%04d|%d|%s|%s" % (spk, i, frames, txt, lang))
    return lines


@pytest.fixture(scope="module")
def script(tmp_path_factory):
    path = tmp_path_factory.mktemp("host") / "script.txt"
    path.write_text("\n".join(_script_lines()) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("s", ["hello world", "été straße", "", "日本語"])
@pytest.mark.parametrize("sos,eos", [(True, True), (False, True),
                                     (True, False)])
def test_text_frontend_matches_jax(s, sos, eos):
    assert text.text_to_byte_sequence(s, sos, eos) == \
        jax_text.text_to_byte_sequence(s, sos, eos)


def test_language_name_to_id_matches_jax():
    for spec in ["en-us:fr-fr", "2", "de-de:xx-xx:1", ["fr-fr", 0]]:
        assert text.language_name_to_id(LANGS, spec) == \
            jax_text.language_name_to_id(LANGS, spec)


@pytest.mark.parametrize("sep", ["|", "\t"])
def test_read_meta_and_eval_filter_match_jax(sep):
    lines = [l.replace("|", sep) for l in _script_lines()]
    for inc in [dict(), dict(inc_lang=["fr-fr"]),
                dict(inc_spk=["spk1", "spk3"])]:
        got = metadata.read_meta(lines, "nlti", **inc)
        assert got == jax_metadata.read_meta(lines, "nlti", **inc)
    assert [metadata.speaker_of(r["n"]) for r in got] == \
        [jax_metadata.speaker_of(r["n"]) for r in got]
    rows = metadata.read_meta(lines, "nlti")
    for n_spk, n_sample in [(3, 4), (1, 2)]:
        assert metadata.filter_eval_samples(list(rows), n_spk, n_sample) == \
            jax_metadata.filter_eval_samples(list(rows), n_spk, n_sample)
    with pytest.raises(ValueError, match="fields"):
        metadata.read_meta(["a|b|c"], "nlti")


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            if isinstance(g[key], np.ndarray):
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize("options", [
    dict(shuffle=False, keep_order=True),
    dict(),
    dict(pick_partial=True),
    dict(eval_lang=["en-us", "de-de"], exclude_spk=["spk1"]),
    dict(eval_spk=["spk0", "spk2"], target_lang="fr-fr"),
    dict(target_spk="spk4", single=True),
], ids=["cli", "shuffled", "pick_partial", "lang_exclude", "spk_target_lang",
        "target_spk_single"])
def test_feeder_eval_batches_match_jax(script, options):
    hp = default_config(**BUDGETS)
    port = FeederEval(None, script, hp, spk_to_id=SPEAKERS,
                      lang_to_id=LANGS, **options)
    ref = JaxFeederEval(None, script, jax_cfg(**BUDGETS),
                        spk_to_id=SPEAKERS, lang_to_id=LANGS, **options)
    _assert_same_batches(port.fetch_data(), ref.fetch_data())
    names = [n for b in port.data for n in b["names"]]
    assert all(not n.endswith("_0005") for n in names)  # over the length cap
    _assert_same_batches(port.fetch_data(exclude=names[:3]),
                         ref.fetch_data(exclude=names[:3]))


def test_feeder_eval_is_synthesis_only(script, tmp_path):
    """Without a zip it batches texts only; a zip path must exist (reading
    mels from a zip is held to JAX in test_torch_feeder.py)."""
    hp = default_config()
    batch = FeederEval(None, script, hp, spk_to_id=SPEAKERS,
                       lang_to_id=LANGS).fetch_data()[0]
    assert "mel_targets" not in batch and "target_lengths" not in batch
    with pytest.raises(FileNotFoundError):
        FeederEval(str(tmp_path / "mels.zip"), script, hp,
                   spk_to_id=SPEAKERS, lang_to_id=LANGS)
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert FeederEval(None, str(empty), hp, spk_to_id=SPEAKERS,
                      lang_to_id=LANGS).fetch_data() == []


def test_mel2wav_and_trim_match_jax(tmp_path):
    hp = default_config(n_iter=3)
    rng = np.random.RandomState(0)
    mel = np.clip(rng.randn(40, hp.num_mels), -4, 4).astype(np.float32)
    mel[:8] = -4.0                                  # leading silence
    jhp = jax_cfg(n_iter=3)
    wav = dsp.mel2wav(mel, hp)
    want = jax_dsp.mel2wav(mel, jhp)
    assert wav.dtype == np.float32 and wav.shape == want.shape
    np.testing.assert_allclose(wav, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(dsp.trim_silence_intervals(wav, hp),
                                  jax_dsp.trim_silence_intervals(want, jhp))
    # too short to invert: silence of the frames' length
    short = dsp.mel2wav(mel[:4], hp)
    np.testing.assert_array_equal(short, jax_dsp.mel2wav(mel[:4], jhp))
    from scipy.io import wavfile
    sr, read = wavfile.read(dsp.save_wav(wav, str(tmp_path / "a.wav"),
                                         hp.sr))
    assert sr == hp.sr and np.abs(read).max() == pytest.approx(1.0)
