"""The port's corpus pipeline (``few_shot_transformer_tts_torch/corpora``)
against the JAX package's, on the CPU, over the same raw layouts made from a
numpy seed.

- Every reader: the same ``metadata.csv`` and wav files, byte for byte.
  ``prepare_hifitts`` reads flac, which needs the soundfile package or the
  ffmpeg binary: its case checks the port's clear error where neither is
  there.
- ``trim_wav`` and ``_peel_edge_spikes``: the same arrays bit for bit and
  the same reasons.
- The whole packer on the numpy path (``--device cpu``), run through the
  port's CLI: the same packed files byte for byte and every mel in
  ``mels.zip`` equal.
- The kernel's mels stage (the default ``--device cuda``) run on the CPU
  through ``_fused_mels``, i.e. on the kernel's plain version: the same
  frame counts, and a packed tree equal to the numpy path's but for the mel
  values; a ragged batch gives each utterance the mel of a call on that
  utterance alone within TOL_RAGGED (the packing leaks nothing); each mel
  within max 1e-2 / mean 1e-5 of the JAX kernel in interpret mode on the
  same pre-emphasised utterance (the bar of ``tests/test_torch_dsp.py``)
  and within max 0.05 / mean 0.01 of numpy (the bar of
  ``tests/test_mel_pallas.py``).
- No fallback: the mels stage on a missing card raises and writes no mel.
- The port's Feeder reads the port's packed output.
"""

import io
import json
import os
import shutil
import sys
import tarfile
import zipfile
from os.path import join

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from few_shot_transformer_tts_tpu.config import default_config as jax_cfg
from few_shot_transformer_tts_tpu.corpora import datasets as jax_ds
from few_shot_transformer_tts_tpu.corpora import process_corpus as jax_pc
from few_shot_transformer_tts_tpu.ops.mel_pallas import \
    fused_frame_mel as jax_fused_frame_mel
from few_shot_transformer_tts_torch.config import (default_config,
                                                   small_test_config)
from few_shot_transformer_tts_torch.corpora import datasets as ds
from few_shot_transformer_tts_torch.corpora import process_corpus as pc
from few_shot_transformer_tts_torch.ops import dsp, dsp_torch, mel

HP = default_config()
TOL_INTERPRET = {"max": 1e-2, "mean": 1e-5}
TOL_NUMPY = {"max": 0.05, "mean": 0.01}
# The plain version's ragged call against its calls on one utterance: the
# same frames, but the products' shapes differ, so a BLAS may sum in another
# order and a magnitude near a bf16 rounding boundary round to its
# neighbour (at most about 3.4e-4 in a band per such flip at max_db 100).
# Frames that read another row's samples or a wrong offset miss by 1e-2
# and more.
TOL_RAGGED = {"max": 5e-3, "mean": 5e-6}
WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliet "
         "kilo lima mike november oscar papa quebec romeo sierra tango "
         "uniform victor whiskey xray yankee zulu").split()


# ---------------------------------------------------------------------------
# raw layouts: tiny wavs of seeded noise; text from a word list
# ---------------------------------------------------------------------------


def write_wav(path, rng, n=None, sr=16000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = n or int(rng.randint(160, 480))
    wavfile.write(path, sr, (rng.randn(n) * 3000).astype(np.int16))


def write_lines(path, rows, encoding="utf-8"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding=encoding) as f:
        f.write("\n".join(rows) + "\n")


def sentence(rng, k=None):
    return " ".join(rng.choice(WORDS, k or int(rng.randint(3, 7))))


def raw_ljspeech(base, rng):
    d = join(base, "LJSpeech-1.1")
    rows = []
    for i in range(6):
        name = "LJ001-%04d" % (i + 1)
        write_wav(join(d, "wavs", name + ".wav"), rng, sr=22050)
        rows.append("%s|raw|Mr. Smith met Dr. Jones at St. Paul, %s %s." % (
            name, sentence(rng), "in 1873" if i == 2 else ""))
    write_lines(join(d, "metadata.csv"), rows)


def raw_databaker(base, rng):
    d = join(base, "BZNSYP")
    chars = "你好世界天气很好我们去公园卡尔普陪外孙玩滑梯"
    lines = []
    for i in range(6):
        fid = "%06d" % (i + 1)
        write_wav(join(d, "Wave", fid + ".wav"), rng)
        text = "".join(rng.choice(list(chars), 8))
        script = "%s#2%s#1%s#4。" % (text[:3], text[3:5], text[5:])
        if i == 3:
            script = "有3个#1人#4。"
        lines += ["%s\t%s" % (fid, script), "ka3 er3 pu3"]
    write_lines(join(d, "ProsodyLabeling", "000001-010000.txt"), lines)


def raw_css10(base, rng):
    scripts = {"de": ["Guten Tag %s" % sentence(rng) for _ in range(4)] +
               ["Kapitel 12"],
               "zh": ["你好２世界", "天气3很好", "我们去公园"],
               "ja": ["こんにちは世界", "今日は１日", "さようなら"]}
    for lang, texts in scripts.items():
        d = join(base, "css10_" + lang)
        rows = []
        for i, text in enumerate(texts):
            name = "book/book_%04d.wav" % i
            write_wav(join(d, name), rng, sr=22050)
            rows.append("%s|%s|%s|1.5" % (name, text, text.lower()))
        write_lines(join(d, "transcript.txt"), rows)


def _caito_book(d, rng, rows):
    lines = []
    for name, script in rows:
        write_wav(join(d, "wavs", name.replace("\x10", "") + ".wav"), rng)
        lines.append("%s|raw|%s" % (name, script))
    write_lines(join(d, "metadata.csv"), lines)


def raw_caito(base, rng):
    judy = [("judy_%04d" % i, sentence(rng)) for i in range(101)]
    judy += [("judy_short", "two words"), ("judy_digit", "chapter 3 begins"),
             ("judy_upper", "THE END OF ALL"), ("\x10judy_fr", sentence(rng))]
    _caito_book(join(base, "en_US", "by_book", "female", "judy_bieber",
                     "book1"), rng, judy)
    _caito_book(join(base, "en_US", "by_book", "male", "elliot_miller",
                     "book2"), rng,
                [("elliot_%04d" % i, sentence(rng)) for i in range(4)])
    _caito_book(join(base, "en_US", "by_book", "mix", "book3"), rng,
                [("mix_%04d" % i, sentence(rng)) for i in range(3)])
    # a row whose wav is missing
    with open(join(base, "en_US", "by_book", "male", "elliot_miller",
                   "book2", "metadata.csv"), "a", encoding="utf-8") as f:
        f.write("elliot_missing|raw|%s\n" % sentence(rng))
    _caito_book(join(base, "uk_UK", "by_book", "male", "obruchov", "book4"),
                rng, [("obr_%04d" % i, sentence(rng)) for i in range(100)])


def _google_lang(d, rng, prefix, n, index="line_index.tsv", wav_dir=""):
    rows = []
    extras = ["[noise]", "abc-en", "x_letter", "a_b"]
    for i in range(n):
        name = "%s_%08d" % (prefix, i)
        write_wav(join(d, wav_dir, name + ".wav"), rng)
        text = "%s %s" % (sentence(rng), extras[i % 4])
        if i == 5:
            text += " 42"
        if index == "line_index.tsv":
            rows.append("%s\t%s" % (name, text))
        else:
            rows.append('( %s "%s" )' % (name, text))
    write_lines(join(d, index), rows)


def raw_google(base, rng):
    g = join(base, "google")
    _google_lang(join(g, "bn_bd_female"), rng, "bnf_00001", 52)
    # the male half arrives as an archive: the extract step unpacks it
    tmp = join(base, "_bn_bd_male")
    _google_lang(tmp, rng, "bnm_00002", 3)
    with zipfile.ZipFile(join(g, "bn_bd_male.zip"), "w") as zf:
        for f in sorted(os.listdir(tmp)):
            zf.write(join(tmp, f), f)
    shutil.rmtree(tmp)
    tmp = join(base, "_gu_in_female")
    _google_lang(tmp, rng, "guf_00003", 51)
    with tarfile.open(join(g, "gu_in_female.tgz"), "w:gz") as tf:
        for f in sorted(os.listdir(tmp)):
            tf.add(join(tmp, f), f)
    shutil.rmtree(tmp)
    _google_lang(join(g, "si_lk"), rng, "sin_2241", 51,
                 index="si_lk.lines.txt", wav_dir="wavs")


def raw_jsut(base, rng):
    root = join(base, "jsut_ver1.1")
    for sub, n in (("basic5000", 102), ("countersuffix26", 3)):
        rows = []
        for i in range(n):
            name = "%s_%04d" % (sub.upper(), i)
            if i != 7:
                write_wav(join(root, sub, "wav", name + ".wav"), rng)
            text = "こんにちは%s" % "".join(rng.choice(list("あいうえお"), 5))
            rows.append("%s:%s" % (name, text + ("３" if i == 4 else "")))
        write_lines(join(root, sub, "transcript_utf8.txt"), rows)


def raw_kss(base, rng):
    d = join(base, "kss")
    rows = []
    for i in range(4):
        rel = "1/1_%04d.wav" % i
        write_wav(join(d, "kss", *rel.split("/")), rng)
        rows.append("%s|그는 괜찮은 척 %d|그는 괜찮은 척|x|1.8|He pretended"
                    % (rel, i))
    write_lines(join(d, "transcript.v.1.4.txt"), rows)


def raw_siwis(base, rng):
    d = join(base, "SiwisFrenchSpeechSynthesisDatabase")
    for part, n in (("part1", 3), ("part2", 3)):
        for i in range(n):
            name = "neut_%s_%04d" % (part, i)
            write_wav(join(d, "wavs", part, name + ".wav"), rng)
            text = "Bonjour %s%s" % (sentence(rng), " 7" if i == 1 else "")
            write_lines(join(d, "text", part, name + ".txt"), [text])


def raw_thorsten(base, rng):
    d = join(base, "thorsten-de_v02", "thorsten-de")
    rows = []
    for i in range(5):
        name = "th%04d" % i
        write_wav(join(d, "wavs", name + ".wav"), rng, sr=22050)
        text = "Hallo Welt %s" % sentence(rng)
        rows.append("%s|%s|%s" % (name, text, text))
    rows.append("thskip|Zahl 42 drin|Zahl 42 drin")
    write_wav(join(d, "wavs", "thskip.wav"), rng)
    write_lines(join(d, "metadata_train.csv"), rows)


def raw_portuguese(base, rng):
    d = join(base, "TTS-Portuguese-Corpus")
    rows = []
    for i in range(5):
        rel = "wavs/sample-%d.wav" % i
        if i != 2:
            write_wav(join(d, *rel.split("/")), rng)
        rows.append("%s==Olá %s" % (rel, sentence(rng)))
    write_lines(join(d, "texts.csv"), rows[::-1])


def raw_enbible(base, rng):
    d = join(base, "enbible")
    rows = []
    for i in range(5):
        name = "gen_%03d" % i
        if i != 1:
            write_wav(join(d, name + ".wav"), rng)
        rows.append("%s\t%s%s\tx" % (name, sentence(rng),
                                      " 3" if i == 3 else ""))
    write_lines(join(d, "transcript.txt"), rows)


def raw_rss(base, rng):
    d = join(base, "rss", "training")
    for sub in ("ele", "rnd"):
        rows = []
        for i in range(3):
            wavid = "%04d" % (i + 1)
            write_wav(join(d, "wav", sub, "adr_%s_%s.wav" % (sub, wavid)),
                      rng)
            rows.append("%s: Bună ziua %s" % (wavid, sentence(rng)))
        write_lines(join(d, "text", sub + ".txt"), rows)


def _pcm(path, rng, frames=2205):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    (rng.randn(frames, 2) * 3000).astype(">i2").tofile(path)


def raw_nst(base, rng):
    # da: line 1752 is deleted (its wav is missing in the corpus), so the
    # script's line 1753 reads recording 1752; digit lines need no audio
    da = join(base, "da.talesyntese")
    lines = ["tal %d" % k for k in range(1753)]
    for k in (0, 1, 2, 1752):
        lines[k] = "Hej  med dig, søde %s" % sentence(rng)
    write_lines(join(da, "rec_scripts", "baseform_data", "all_script_orig"),
                lines, encoding="iso-8859-1")
    for k in (1, 2, 3, 1752):
        _pcm(join(da, "all_rec", "all_script_ca_01_%04d.pcm" % k), rng)
    nb = join(base, "ibm.talesyntese.nor")
    lines = ["Hei på deg, blåbær %s" % sentence(rng) for _ in range(4)]
    write_lines(join(nb, "pcm", "cs", "SCRIPTS", "CTTS_core.ORIGINAL"),
                lines, encoding="iso-8859-1")
    for k in (1, 2, 3):
        _pcm(join(nb, "pcm", "cs", "ctts_core_cs_01_%04d.pcm" % k), rng)


def raw_hifitts(base, rng):
    d = join(base, "hi_fi_tts_v0", "hi_fi_tts_v0")
    for sid in ("92", "6097", "9017"):
        rel = "audio/%s_clean/book/x_%s.flac" % (sid, sid)
        os.makedirs(os.path.dirname(join(d, rel)), exist_ok=True)
        with open(join(d, rel), "wb") as f:
            f.write(b"fLaC" + rng.bytes(64))
        write_lines(join(d, sid + "_manifest_clean_train.json"), [json.dumps(
            {"audio_filepath": rel, "text_normalized": sentence(rng)})])


def raw_lsru(base, rng):
    root = join(base, "ruls_data", "train")
    rows = []
    for spk, n in (("1000", 104), ("2000", 4)):
        for i in range(n):
            rel = "audio/%s/book%d/%s_%04d.wav" % (spk, i % 2, spk, i)
            write_wav(join(root, *rel.split("/")), rng)
            text = "Привет %s%s" % (sentence(rng), " 5" if i == 9 else "")
            rows.append(json.dumps({
                "audio_filepath": rel, "score": -2.0 if i in (3, 4) else 0.5,
                "text_no_preprocessing": text}, ensure_ascii=False))
    write_lines(join(root, "manifest.json"), rows)


READERS = {
    "ljspeech": (raw_ljspeech, lambda m, b, o: m.prepare_ljspeech(b, o)),
    "databaker": (raw_databaker, lambda m, b, o: m.prepare_databaker(b, o)),
    "css10": (raw_css10, lambda m, b, o: m.prepare_css10(
        b, o, langs=["de_de", "fi_fi", "zh_cn", "ja_jp"])),
    "caito": (raw_caito, lambda m, b, o: m.prepare_caito(
        b, o, langs=["en_US", "de_DE", "uk_UK"])),
    "google": (raw_google, lambda m, b, o: (m.google_extract(b),
                                            m.prepare_google(b, o))),
    "jsut": (raw_jsut, lambda m, b, o: m.prepare_jsut(b, o)),
    "kss": (raw_kss, lambda m, b, o: m.prepare_kss(b, o)),
    "siwis": (raw_siwis, lambda m, b, o: m.prepare_siwis(b, o)),
    "thorsten": (raw_thorsten, lambda m, b, o: m.prepare_thorsten(b, o)),
    "portuguese": (raw_portuguese,
                   lambda m, b, o: m.prepare_portuguese(b, o)),
    "enbible": (raw_enbible, lambda m, b, o: m.prepare_enbible(b, o)),
    "rss": (raw_rss, lambda m, b, o: m.prepare_rss(b, o)),
    "nst": (raw_nst, lambda m, b, o: m.prepare_nst(b, o)),
    "lsru": (raw_lsru, lambda m, b, o: m.prepare_lsru(b, o)),
}


def tree_bytes(root):
    """{relative path: bytes} of every file under root, but archives (their
    headers hold the time they were made)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith((".zip", ".tgz")):
                continue
            with open(join(dirpath, f), "rb") as fh:
                out[os.path.relpath(join(dirpath, f), root)] = fh.read()
    return out


def assert_same_tree(got, want):
    got, want = tree_bytes(got), tree_bytes(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_readers_cover_every_preparer():
    assert sorted(ds.ALL_PREPARERS) == sorted(jax_ds.ALL_PREPARERS) == \
        sorted(list(READERS) + ["hifitts"])


@pytest.mark.parametrize("reader", sorted(READERS))
def test_reader_matches_jax(reader, tmp_path):
    make, run = READERS[reader]
    for side in ("jax", "port"):
        make(str(tmp_path / side / "raw"), np.random.RandomState(7))
    run(jax_ds, str(tmp_path / "jax" / "raw"), str(tmp_path / "jax" / "out"))
    run(ds, str(tmp_path / "port" / "raw"), str(tmp_path / "port" / "out"))
    corpora = sorted(os.listdir(tmp_path / "jax" / "out"))
    assert corpora and corpora == sorted(os.listdir(tmp_path / "port" /
                                                    "out"))
    for corpus in corpora:
        meta = tmp_path / "port" / "out" / corpus / "metadata.csv"
        assert meta.read_text(encoding="utf-8").count("\n") >= 1, corpus
    assert_same_tree(str(tmp_path / "port" / "out"),
                     str(tmp_path / "jax" / "out"))
    # the readers that unpack or move raw files leave the same raw tree
    assert_same_tree(str(tmp_path / "port" / "raw"),
                     str(tmp_path / "jax" / "raw"))


def test_hifitts_without_soundfile_or_ffmpeg_raises(tmp_path, monkeypatch):
    raw_hifitts(str(tmp_path / "raw"), np.random.RandomState(7))
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="soundfile.*ffmpeg"):
        ds.prepare_hifitts(str(tmp_path / "raw"), str(tmp_path / "out"))


# ---------------------------------------------------------------------------
# trim
# ---------------------------------------------------------------------------


def voice(rng, seconds, sr=16000):
    """Voice-like audio: seven harmonics of a wandering pitch under a
    syllable-rate envelope, plus noise."""
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    pitch = rng.uniform(90, 250) * (1 + 0.1 * np.sin(
        2 * np.pi * rng.uniform(0.2, 1.0) * t))
    phase = 2 * np.pi * np.cumsum(pitch) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t +
                            rng.uniform(0, 2 * np.pi)))
    return (0.3 * env * voiced + 0.01 * rng.randn(n)).astype(np.float32)


def quiet(rng, seconds, sr=16000):
    return (1e-4 * rng.randn(int(round(seconds * sr)))).astype(np.float32)


def click(rng, amp):
    y = quiet(rng, 0.05)
    y[300:330] += amp
    return y


TRIM_CASES = {
    "clean": lambda r: [quiet(r, 0.3), voice(r, 2.2), quiet(r, 0.5)],
    "edge_clicks": lambda r: [click(r, 0.02), quiet(r, 0.6), voice(r, 2.0),
                              quiet(r, 0.6), click(r, 0.05)],
    "loud_click": lambda r: [click(r, 0.9), quiet(r, 0.4), voice(r, 1.6)],
    "gap": lambda r: [voice(r, 1.5), quiet(r, 1.5), voice(r, 1.5)],
    "short_gap": lambda r: [voice(r, 1.5), quiet(r, 1.0), voice(r, 1.5)],
    "too_short": lambda r: [quiet(r, 0.2), voice(r, 0.5), quiet(r, 0.2)],
    "too_long": lambda r: [voice(r, 21.0)],
    "silent": lambda r: [np.zeros(24000, np.float32)],
}


@pytest.mark.parametrize("corpus", ["ljspeech", "css10_de"])
@pytest.mark.parametrize("case", sorted(TRIM_CASES))
def test_trim_wav_matches_jax(case, corpus):
    y = np.concatenate(TRIM_CASES[case](np.random.RandomState(3)))
    got, got_reason = pc.trim_wav(y, corpus)
    want, want_reason = jax_pc.trim_wav(y, corpus)
    assert got_reason == want_reason
    if want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if case in ("gap", "too_short", "too_long"):
        assert got is None and got_reason == ("length" if "too" in case
                                              else "gap")
    if case == "short_gap":     # over 0.768 s, under css10's 1 s
        assert (got is None) == (corpus == "ljspeech")


def _peel_case(case):
    rng = np.random.RandomState(0)
    y = np.zeros(60000, np.float32)
    y[1000:1020] = 0.05
    y[20000:36000] = rng.uniform(-1, 1, 16000).astype(np.float32)
    y[50000:50100] = 0.2
    y_abs = np.abs(y)
    if case == "both_ends":
        return [[1000, 1020], [20000, 36000], [50000, 50100]], y_abs, \
            ([[20000, 36000]], 2)
    if case == "loud_and_empty":
        y_abs[1000:1010] = 0.9
        return [[1000, 1010], [1010, 1010], [20000, 36000]], y_abs, \
            ([[1000, 1010], [1010, 1010], [20000, 36000]], 0)
    return [[17000, 17020], [20000, 36000]], y_abs, \
        ([[17000, 17020], [20000, 36000]], 0)


@pytest.mark.parametrize("case", ["both_ends", "loud_and_empty",
                                  "close_spike"])
def test_peel_edge_spikes_matches_jax(case):
    spans, y_abs, expected = _peel_case(case)
    got = pc._peel_edge_spikes([list(s) for s in spans], y_abs, 1.0)
    want = jax_pc._peel_edge_spikes([list(s) for s in spans], y_abs, 1.0)
    assert got == want == expected


# ---------------------------------------------------------------------------
# the packer
# ---------------------------------------------------------------------------


def utterance(rng, sr=22050):
    return np.concatenate([quiet(rng, rng.uniform(0.05, 0.3), sr),
                           voice(rng, rng.uniform(0.8, 1.3), sr),
                           quiet(rng, rng.uniform(0.05, 0.3), sr)])


def write_wav_float(path, y, sr=22050):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, sr, (np.clip(y, -1, 1) * 32767).astype(np.int16))


def raw_packer_corpora(base, seed=11):
    """LJSpeech (en-us, 104 utterances), thorsten and CSS10 German (de-de,
    52 each), with a duplicate text, a digit row and utterances the trim
    stage rejects for gap and for length."""
    rng = np.random.RandomState(seed)
    lj = join(base, "LJSpeech-1.1")
    rows = []
    for i in range(104):
        name = "LJ002-%04d" % i
        y = utterance(rng)
        if i == 10:
            y = np.concatenate([y, quiet(rng, 1.2, 22050), y])
        if i == 11:
            y = voice(rng, 0.4, 22050)
        write_wav_float(join(lj, "wavs", name + ".wav"), y)
        rows.append("%s|raw|%s" % (name, sentence(rng, 8)))
    write_lines(join(lj, "metadata.csv"), rows)
    th = join(base, "thorsten-de_v02", "thorsten-de")
    rows = []
    for i in range(52):
        name = "th%04d" % i
        write_wav_float(join(th, "wavs", name + ".wav"), utterance(rng))
        text = sentence(rng, 8) if i != 5 else rows[0].split("|")[1]
        rows.append("%s|%s|%s" % (name, text + (" 42" if i == 7 else ""),
                                  text))
    write_lines(join(th, "metadata_train.csv"), rows)
    css = join(base, "css10_de")
    rows = []
    for i in range(52):
        name = "buch/buch_%04d.wav" % i
        write_wav_float(join(css, name), utterance(rng))
        rows.append("%s|raw|%s|1.5" % (name, sentence(rng, 8)))
    write_lines(join(css, "transcript.txt"), rows)


@pytest.fixture(scope="module")
def packer(tmp_path_factory):
    """The same transformed tree packed by the JAX functions, by the port's
    CLI (numpy path, ``--device cpu``) and by the port's kernel stage on the
    CPU (``_fused_mels``, in batches of at most 600 frames: several ragged
    batches) with the CLI's merge and stats, with the per-corpus speaker
    minimum relaxed as tests/test_corpora.py does."""
    root = tmp_path_factory.mktemp("packer")
    raw = str(root / "raw")
    raw_packer_corpora(raw)
    for side in ("jax", "port"):
        out = str(root / side / "transformed")
        m = jax_ds if side == "jax" else ds
        m.prepare_ljspeech(raw, out)
        m.prepare_thorsten(raw, out)
        m.prepare_css10(raw, out, langs=["de_de"])
    paths = {side: (str(root / side / "transformed"),
                    str(root / side / "packed"))
             for side in ("jax", "port", "fused")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pc, "min_speaker_samples", lambda c: 1)
        mp.setattr(pc, "min_speaker_samples", lambda c: 1)
        mp.setattr(pc, "MEL_BATCH_FRAMES", 600)
        t, p = paths["jax"]
        jax_pc.trim_audios(None, t)
        jax_pc.recollect_meta(None, t)
        jax_pc.build_mels(None, t, jax_cfg())
        jax_pc.merge_datasets(t, p)
        jax_pc.statistics(t, p)
        t, p = paths["port"]
        pc.main(["--transformed", t, "--packed", p, "--stages",
                 "trim,meta", "--workers", "1", "--device", "cpu"])
        shutil.copytree(t, paths["fused"][0])
        pc.main(["--transformed", t, "--packed", p, "--stages",
                 "mels,merge,stats", "--workers", "1", "--device", "cpu"])
        t, p = paths["fused"]
        ragged = dsp_torch.melspectrogram_ragged
        calls = []
        mp.setattr(pc.dsp_torch, "melspectrogram_ragged",
                   lambda wavs, *a: calls.append(len(wavs)) or
                   ragged(wavs, *a))
        for corpus in sorted(os.listdir(t)):
            pc._fused_mels(pc._mel_jobs(join(t, corpus)), HP,
                           torch.device("cpu"), 2)
        pc.main(["--transformed", t, "--packed", p, "--stages",
                 "merge,stats"])
    paths["fused_batches"] = calls
    return paths


def zip_mels(packed):
    with zipfile.ZipFile(join(packed, "mels.zip")) as zf:
        return {n: np.load(io.BytesIO(zf.read(n))) for n in zf.namelist()}


PACKED_FILES = ("metadata.train.txt", "metadata.eval.txt", "lang_id.json",
                "spk_id.json", "lang_stat.tsv")


def read(path):
    with open(path, "rb") as f:
        return f.read()


def test_packer_matches_jax_bit_for_bit(packer):
    (tj, pj), (tp, pp) = packer["jax"], packer["port"]
    for name in PACKED_FILES:
        assert read(join(pp, name)) == read(join(pj, name)), name
    got, want = zip_mels(pp), zip_mels(pj)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
    for corpus in ("ljspeech", "thorsten", "css10_de"):
        assert read(join(tp, corpus, "metadata.csv")) == \
            read(join(tj, corpus, "metadata.csv"))
        assert_same_tree(join(tp, corpus, "proc_wavs"),
                         join(tj, corpus, "proc_wavs"))
    # what the inputs were made to exercise: the trim stage's rejects, the
    # dedup and digit skips, two languages, the eval split of 100
    lj = read(join(tp, "ljspeech", "metadata.csv")).decode().splitlines()
    assert len(lj) == 102
    assert json.loads(read(join(pp, "lang_id.json"))) == {"de-de": 0,
                                                          "en-us": 1}
    evals = read(join(pp, "metadata.eval.txt")).decode().splitlines()
    assert len(evals) == 200


def test_fused_stage_on_cpu_matches_numpy_path(packer):
    (_, pn), (tf, pf) = packer["port"], packer["fused"]
    for name in PACKED_FILES:
        assert read(join(pf, name)) == read(join(pn, name)), name
    got, want = zip_mels(pf), zip_mels(pn)
    assert sorted(got) == sorted(want)
    worst = []
    for name in want:
        assert got[name].dtype == np.float32
        assert got[name].shape == want[name].shape
        err = np.abs(got[name] - want[name])
        worst.append((err.max(), err.mean()))
    assert max(w[0] for w in worst) <= TOL_NUMPY["max"], max(worst)
    assert max(w[1] for w in worst) <= TOL_NUMPY["mean"], max(worst)


def test_ragged_batch_leaks_nothing():
    """Each row of a ragged batch is the mel of a call on that utterance
    alone within TOL_RAGGED, and within TOL_INTERPRET of the JAX kernel in
    interpret mode on the same pre-emphasised utterance."""
    rng = np.random.RandomState(9)
    wavs = [torch.from_numpy(voice(rng, n / 16000.0))
            for n in (1100, 2600, 4017, 7777, 12000)]
    mels = dsp_torch.melspectrogram_ragged(wavs, HP, "cpu")
    for w, got in zip(wavs, mels):
        pre = dsp_torch.preemphasis(w[None], HP.preemphasis)
        assert got.shape == (1 + w.shape[0] // HP.hop_length, HP.num_mels)
        alone = mel.fused_frame_mel(pre, HP)[0]
        assert_within(got.numpy(), alone.numpy(), TOL_RAGGED)
        want = np.asarray(jax_fused_frame_mel(jnp.asarray(pre.numpy()),
                                              jax_cfg(), interpret=True))[0]
        err = np.abs(got.numpy() - want)
        assert err.max() <= TOL_INTERPRET["max"], err.max()
        assert err.mean() <= TOL_INTERPRET["mean"], err.mean()


def assert_within(got, want, tol):
    err = np.abs(got - want)
    assert err.max() <= tol["max"], err.max()
    assert err.mean() <= tol["mean"], err.mean()


def test_fused_stage_batches_and_saves_single_call_mels(packer):
    """The stage made one ragged call a batch of ``mel_batches``, in the
    packer's order of corpora, and saved for each utterance its mel of a
    call on it alone, within TOL_RAGGED."""
    t = packer["fused"][0]
    corpora = {}
    for corpus in sorted(os.listdir(t)):
        names = [l.split("|")[0] for l in read(join(
            t, corpus, "metadata.csv")).decode().splitlines()]
        lengths = [dsp.load_wav(join(t, corpus, "proc_wavs",
                                     n + ".wav")).shape[0] for n in names]
        corpora[corpus] = names, lengths, pc.mel_batches(lengths, HP, 600)
    assert packer["fused_batches"] == [len(b) for c in sorted(corpora)
                                       for b in corpora[c][2]]
    names, lengths, batches = corpora["ljspeech"]
    assert len(batches) > 3 and max(len(b) for b in batches) > 1
    batch = max(batches, key=lambda b: max(lengths[i] for i in b) -
                min(lengths[i] for i in b))
    assert len({lengths[i] // HP.hop_length for i in batch}) > 1
    for i in batch:
        w = torch.from_numpy(dsp.load_wav(join(t, "ljspeech", "proc_wavs",
                                               names[i] + ".wav")))
        alone = mel.fused_frame_mel(
            dsp_torch.preemphasis(w[None], HP.preemphasis), HP)[0]
        saved = np.load(join(t, "ljspeech", "mels", names[i] + ".npy"))
        assert saved.dtype == np.float32
        assert saved.shape == alone.shape
        assert_within(saved, alone.numpy(), TOL_RAGGED)


def test_mel_batches_keep_the_budget():
    rng = np.random.RandomState(5)
    lengths = [int(x) for x in rng.randint(1000, 300000, 200)]
    batches = pc.mel_batches(lengths, HP, 4000)
    assert [i for b in batches for i in b] == list(range(200))
    frames = lambda b: sum(1 + lengths[i] // HP.hop_length for i in b)
    for b, nxt in zip(batches, batches[1:] + [None]):
        assert frames(b) <= 4000 or len(b) == 1
        # a batch closes only when the next utterance would overflow it
        assert nxt is None or frames(b + nxt[:1]) > 4000
    assert pc.mel_batches([], HP) == []


def test_ragged_layout_is_checked():
    """``fused_frame_mel_ragged`` refuses a row whose frames leave the
    signal, a row without frames and mismatched starts and counts, on the
    CPU as on a card (the check runs before either route)."""
    signal = torch.zeros(3 * HP.n_fft)
    ok = mel.fused_frame_mel_ragged(signal, [0, HP.n_fft], [1, 2], HP)
    assert ok.shape == (3, HP.num_mels)
    for starts, frames in (([0, 2 * HP.n_fft], [1, 6]), ([0], [0]),
                           ([0, 1], [1]), ([-1], [1])):
        with pytest.raises(ValueError):
            mel.fused_frame_mel_ragged(signal, starts, frames, HP)


def test_mels_stage_without_cuda_raises(tmp_path, monkeypatch):
    """The mels stage on its default device, on a machine without a card,
    raises; it never falls back to the numpy path or the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = str(tmp_path / "transformed")
    corpus = join(t, "thorsten")
    write_wav_float(join(corpus, "proc_wavs", "thorsten_0000000000.wav"),
                    utterance(np.random.RandomState(0), 16000), 16000)
    write_lines(join(corpus, "metadata.csv"),
                ["thorsten_0000000000|Hallo Welt|thorsten|de_de"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.build_mels(None, t, HP)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc.main(["--transformed", t, "--stages", "mels"])
    assert not os.path.exists(join(corpus, "mels")) or \
        not os.listdir(join(corpus, "mels"))


def test_feeder_reads_the_ports_packed_output(packer):
    from few_shot_transformer_tts_torch.data import Feeder
    packed = packer["fused"][1]
    hp = small_test_config(num_mels=80, bucket_size=4, data_warmup_steps=0,
                           batch_frame_limit=2000,
                           batch_frame_quad_limit=10 ** 9)
    with open(join(packed, "lang_id.json")) as f:
        lang_to_id = json.load(f)
    with open(join(packed, "spk_id.json")) as f:
        spk_to_id = json.load(f)
    feeder = Feeder(join(packed, "mels.zip"),
                    join(packed, "metadata.train.txt"), hp,
                    spk_to_id=spk_to_id, lang_to_id=lang_to_id)
    feeder.global_step = 10 ** 6
    examples = feeder.get_examples(4)
    assert len(examples) == 4
    assert all(ex["mel_target"].shape[1] == 80 for ex in examples)
    assert all(ex["input"][0] == 2 for ex in examples)
