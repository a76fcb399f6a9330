"""Per-dataset corpus adapters (reference corpora/{ljspeech,databaker,css10,
caito,google,jsut,kss,siwis,thorsten,portuguese,enbible,rss,nst,hifitts,
lsru}.py).

Each adapter normalizes one public dataset into the shared contract
``{transformed}/{corpus}/wavs/{SPK}_{%010d}.wav`` + ``metadata.csv`` rows
``name|script|speaker|lang`` with the same text handling and filters as its
reference counterpart; the shared machinery lives in common.py.

Own copy of ``few_shot_transformer_tts_tpu/corpora/datasets.py``: each
reader writes the same wavs and ``metadata.csv`` as its counterpart there.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess

from . import dataset_path as default_dataset_path
from . import transformed_path as default_transformed_path
from .common import (CorpusWriter, group_speaker_samples, has_digit,
                     has_ascii_digit, wav_duration, load_audio,
                     load_raw_pcm16be)

# ---------------------------------------------------------------------------
# ljspeech (reference corpora/ljspeech.py)
# ---------------------------------------------------------------------------

_ABBREVIATIONS = [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]
_ABBREV_RES = [(re.compile(r"\b%s\." % a, re.IGNORECASE), b)
               for a, b in _ABBREVIATIONS]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREV_RES:
        text = re.sub(regex, replacement, text)
    return text


def prepare_ljspeech(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    in_path = os.path.join(dataset_path, "LJSpeech-1.1")
    w = CorpusWriter(transformed_path, "ljspeech")
    for line in open(os.path.join(in_path, "metadata.csv"),
                     encoding="utf-8").read().splitlines():
        filename, _, script = line.split("|")
        script = expand_abbreviations(script)
        w.add(os.path.join(in_path, "wavs", filename + ".wav"), script,
              "ljspeech", "en_us")
    w.finish()
    return w


# ---------------------------------------------------------------------------
# databaker (reference corpora/databaker.py): zh prosody markers #N stripped
# ---------------------------------------------------------------------------


def strip_prosody_markers(script: str) -> str:
    for j in reversed(range(len(script))):
        if script[j] == "#" and j + 1 < len(script) and script[j + 1].isdigit():
            script = script[:j] + script[j + 2:]
    return script


def prepare_databaker(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    in_path = os.path.join(dataset_path, "BZNSYP")
    w = CorpusWriter(transformed_path, "databaker")
    lines = open(os.path.join(in_path, "ProsodyLabeling", "000001-010000.txt"),
                 encoding="utf-8").read().strip().splitlines()[0::2]
    for line in lines:
        filename, script = line.strip().split("\t")
        script = strip_prosody_markers(script)
        if has_digit(script):
            w.skip()
            continue
        w.add(os.path.join(in_path, "Wave", filename + ".wav"), script,
              "databaker", "zh_cn")
    w.finish()
    return w


# ---------------------------------------------------------------------------
# css10 (reference corpora/css10.py)
# ---------------------------------------------------------------------------

CSS10_LANGS = ["de_de", "el_gr", "es_es", "fi_fi", "fr_fr", "hu_hu", "ja_jp",
               "nl_nl", "ru_ru", "zh_cn"]


def prepare_css10(dataset_path=None, transformed_path=None, langs=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    for lang_name in (langs or CSS10_LANGS):
        sub = "css10_" + lang_name.split("_")[0]
        base = os.path.join(dataset_path, sub)
        if not os.path.isdir(base):
            continue
        w = CorpusWriter(transformed_path, sub)
        spk = "css10" + lang_name[:2].upper()
        for line in open(os.path.join(base, "transcript.txt"),
                         encoding="utf-8").read().splitlines():
            filename, script_raw, script, _ = line.split("|")
            if lang_name in ["zh_cn", "ja_jp"]:
                script = script_raw
            if lang_name == "zh_cn":
                # drop full-width/unicode digits, keep ascii for the skip test
                script = "".join(c for c in script
                                 if not (c.isdigit() and c not in "0123456789"))
            if has_digit(script):
                w.skip()
                continue
            w.add(os.path.join(base, filename), script, spk, lang_name)
        w.finish()


# ---------------------------------------------------------------------------
# caito / M-AILABS (reference corpora/caito.py)
# ---------------------------------------------------------------------------

CAITO_LANGS = ["en_US", "en_UK", "de_DE", "es_ES", "it_IT", "uk_UK", "ru_RU",
               "pl_PL", "fr_FR"]


def prepare_caito(dataset_path=None, transformed_path=None, langs=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    seen_spk = {}
    for sub in (langs or CAITO_LANGS):
        base = os.path.join(dataset_path, sub)
        if not os.path.isdir(base):
            continue
        lang_name = sub.lower()
        if lang_name == "uk_uk":
            lang_name = "uk_ua"
        stream = []
        n_skip = 0
        for f in glob.iglob(os.path.join(base, "**", "metadata.csv"),
                            recursive=True):
            book_dir = os.path.dirname(f)
            spk = os.path.basename(os.path.dirname(book_dir))
            if spk == "mix":
                continue
            for line in open(f, encoding="utf-8").read().splitlines():
                parts = line.split("|")
                parts[0] = parts[0].replace("\x10", "")  # fr-fr naming fix
                wav_file = os.path.join(book_dir, "wavs", parts[0] + ".wav")
                if not os.path.exists(wav_file):
                    print("Missing:", wav_file)
                    continue
                script = parts[2]
                if len(script.split(" ")) <= 2 or has_digit(script):
                    n_skip += 1
                    continue
                if script.isupper():
                    script = script.lower()
                dur = wav_duration(wav_file) - 1
                stream.append((wav_file, script, dur, spk))
        spk_samples, extra_skip, n_spk_skip = group_speaker_samples(stream, 100)
        w = CorpusWriter(transformed_path, "caito_" + lang_name)
        w.skip(n_skip + extra_skip)
        for spk in spk_samples:
            short = spk.split("_")[-1]
            if short in seen_spk and seen_spk[short] != (spk, lang_name):
                raise ValueError("Spk name conflict: %s vs %s" %
                                 ((spk, lang_name), seen_spk[short]))
            seen_spk[short] = (spk, lang_name)
            for wav_file, script, dur in spk_samples[spk]:
                w.add(wav_file, script, short, lang_name, dur=dur)
        w.finish()


# ---------------------------------------------------------------------------
# google language resources (reference corpora/google.py)
# ---------------------------------------------------------------------------


def clean_google_script(script: str) -> str:
    """Bracketed-word removal and suffix cleanup
    (reference corpora/google.py:80-93)."""
    if script[-2:] == "\\n":
        script = script[:-2]
    words = [w for w in script.split(" ") if w]
    for k, word in enumerate(words):
        if word[0] == "[" and word[-1] == "]":
            words[k] = ""
        elif word.endswith("-en"):
            words[k] = word[:-3].upper()
        elif word.endswith("_letter") or word.endswith("_Letter"):
            words[k] = word[:-7].upper()
        elif "_" in word:
            words[k] = word.split("_")[0] + "_"
    return " ".join(w for w in words if w)


def google_extract(dataset_path=None):
    """Unpack downloaded archives and merge the male/female halves per
    language (reference corpora/google.py:17-55)."""
    dataset_path = dataset_path or default_dataset_path
    base = os.path.join(dataset_path, "google")
    for f in glob.iglob(os.path.join(base, "*")):
        if f.split(".")[-1] in ["zip", "tgz", "gz"]:
            out_dir = os.path.join(base, os.path.basename(f).split(".")[0])
            if os.path.exists(out_dir):
                continue
            os.makedirs(out_dir, exist_ok=True)
            if f.endswith("zip"):
                subprocess.run(["unzip", "-q", f, "-d", out_dir], check=True)
            else:
                subprocess.run(["tar", "-xzf", f, "-C", out_dir], check=True)
    for f in glob.iglob(os.path.join(base, "*")):
        if not os.path.isdir(f):
            continue
        os.makedirs(os.path.join(f, "wavs"), exist_ok=True)
        for wav in glob.iglob(os.path.join(f, "*.wav")):
            dst = os.path.join(f, "wavs", os.path.basename(wav))
            if not os.path.exists(dst):
                os.replace(wav, dst)
    for f in glob.iglob(os.path.join(base, "*")):
        if not f.endswith("male"):      # matches 'male' and 'female'
            continue
        lang_name = os.path.basename(f)[:5]
        out_path = os.path.join(base, lang_name)
        os.makedirs(os.path.join(out_path, "wavs"), exist_ok=True)
        for wav in glob.iglob(os.path.join(f, "wavs", "*.wav")):
            dst = os.path.join(out_path, "wavs", os.path.basename(wav))
            if not os.path.exists(dst):
                os.replace(wav, dst)
        lines = open(os.path.join(f, "line_index.tsv"),
                     encoding="utf-8").read().splitlines()
        with open(os.path.join(out_path, "line_index.tsv"), "a",
                  encoding="utf-8") as fw:
            fw.writelines(l + "\n" for l in lines)


def prepare_google(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "google")
    for f in sorted(glob.iglob(os.path.join(base, "*"))):
        lang = os.path.basename(f)
        if not os.path.isdir(f) or len(lang) != 5:
            continue
        if os.path.exists(os.path.join(transformed_path, "google_" + lang)):
            continue
        _process_google_lang(f, lang, transformed_path)


def _process_google_lang(base_path, lang, transformed_path):
    index = "si_lk.lines.txt" if lang == "si_lk" else "line_index.tsv"
    stream = []
    n_skip = 0
    for sample in open(os.path.join(base_path, index),
                       encoding="utf-8").read().splitlines():
        if lang == "si_lk":
            name = sample.split('"')[0][1:].strip()
            script = sample[len(sample.split('"')[0]) + 1: -3].strip()
        else:
            name = sample.split("\t")[0]
            script = sample.split("\t")[-1].strip()
        if len(script) == 0:
            continue
        if name.endswith(".wav"):
            name = name[:-4]
        script = clean_google_script(script)
        spk = name.split("_")[0] + name.split("_")[1]
        wav_file = os.path.join(base_path, "wavs", name + ".wav")
        if has_ascii_digit(script):
            n_skip += 1
            continue
        stream.append((wav_file, script, wav_duration(wav_file), spk))
    spk_samples, extra_skip, n_spk_skip = group_speaker_samples(stream, 50)
    w = CorpusWriter(transformed_path, "google_" + lang)
    w.skip(n_skip + extra_skip)
    for spk in sorted(spk_samples.keys()):
        for wav_file, script, dur in spk_samples[spk]:
            w.add(wav_file, script, spk, lang, dur=dur)
    w.finish()


# ---------------------------------------------------------------------------
# jsut (reference corpora/jsut.py)
# ---------------------------------------------------------------------------


def prepare_jsut(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "jsut_ver1.1")
    filter_sub = ["countersuffix26", "repeat500"]
    stream = []
    n_skip = 0
    for f in glob.iglob(os.path.join(base, "**", "transcript_utf8.txt"),
                        recursive=True):
        sub_dir = os.path.dirname(f)
        if os.path.basename(sub_dir) in filter_sub:
            continue
        spk = os.path.basename(os.path.dirname(sub_dir))
        if spk == "jsut_ver1.1":
            spk = "jsut"
        for line in open(f, encoding="utf-8").read().splitlines():
            filename = line.split(":")[0]
            script = line[len(filename) + 1:]
            wav_file = os.path.join(sub_dir, "wav", filename + ".wav")
            if not os.path.exists(wav_file):
                print("Missing:", wav_file)
                continue
            if has_digit(script):
                n_skip += 1
                continue
            stream.append((wav_file, script, wav_duration(wav_file) - 1, spk))
    spk_samples, extra_skip, _ = group_speaker_samples(stream, 100)
    w = CorpusWriter(transformed_path, "jsut")
    w.skip(n_skip + extra_skip)
    for spk in sorted(spk_samples.keys()):
        for wav_file, script, dur in spk_samples[spk]:
            w.add(wav_file, script, spk, "ja_jp", dur=dur)
    w.finish()


# ---------------------------------------------------------------------------
# kss (reference corpora/kss.py) — no digit filter
# ---------------------------------------------------------------------------


def prepare_kss(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "kss")
    w = CorpusWriter(transformed_path, "kss")
    for line in open(os.path.join(base, "transcript.v.1.4.txt"),
                     encoding="utf-8").read().splitlines():
        parts = line.split("|")
        filename = os.path.join(*parts[0].split("/"))
        w.add(os.path.join(base, "kss", filename), parts[2], "kss", "ko_kr")
    w.finish()


# ---------------------------------------------------------------------------
# siwis (reference corpora/siwis.py)
# ---------------------------------------------------------------------------


def prepare_siwis(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "SiwisFrenchSpeechSynthesisDatabase")
    w = CorpusWriter(transformed_path, "siwis")
    wav_files = (sorted(glob.glob(os.path.join(base, "wavs", "part1", "*.wav")))
                 + sorted(glob.glob(os.path.join(base, "wavs", "part2",
                                                 "*.wav"))))
    for wav_file in wav_files:
        rel = os.path.relpath(wav_file, os.path.join(base, "wavs"))
        txt = os.path.join(base, "text", rel[:-4] + ".txt")
        script = open(txt, encoding="utf-8").read().strip()
        if has_digit(script):
            w.skip()
            continue
        w.add(wav_file, script, "siwis", "fr_fr")
    w.finish()


# ---------------------------------------------------------------------------
# thorsten (reference corpora/thorsten.py)
# ---------------------------------------------------------------------------


def prepare_thorsten(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "thorsten-de_v02", "thorsten-de")
    w = CorpusWriter(transformed_path, "thorsten")
    for line in open(os.path.join(base, "metadata_train.csv"),
                     encoding="utf-8").read().splitlines():
        filename, script = line.split("|")[:2]
        if has_digit(script):
            w.skip()
            continue
        w.add(os.path.join(base, "wavs", filename + ".wav"), script,
              "thorsten", "de_de")
    w.finish()


# ---------------------------------------------------------------------------
# portuguese (reference corpora/portuguese.py)
# ---------------------------------------------------------------------------


def prepare_portuguese(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "TTS-Portuguese-Corpus")
    w = CorpusWriter(transformed_path, "pt_br")
    for line in sorted(open(os.path.join(base, "texts.csv"),
                            encoding="utf-8").read().splitlines()):
        rel = line.split("=")[0]
        filename = os.path.join(*rel.split("/"))
        script = line[len(rel) + 1:].strip()
        wav_file = os.path.join(base, filename)
        if not os.path.exists(wav_file):
            print("Missing", wav_file)
            continue
        w.add(wav_file, script, "ptbr", "pt_br")
    w.finish()


# ---------------------------------------------------------------------------
# enbible (reference corpora/enbible.py)
# ---------------------------------------------------------------------------


def prepare_enbible(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "enbible")
    w = CorpusWriter(transformed_path, "enbible")
    for line in sorted(open(os.path.join(base, "transcript.txt"),
                            encoding="utf-8").read().splitlines()):
        filename, script, _ = line.split("\t")
        wav_file = os.path.join(base, filename + ".wav")
        if not os.path.exists(wav_file):
            print("Missing", wav_file)
            continue
        if has_digit(script):
            w.skip()
            continue
        w.add(wav_file, script, "enbible", "en_us")
    w.finish()


# ---------------------------------------------------------------------------
# rss (reference corpora/rss.py)
# ---------------------------------------------------------------------------


def prepare_rss(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    base = os.path.join(dataset_path, "rss", "training")
    w = CorpusWriter(transformed_path, "rss")
    for f in sorted(glob.iglob(os.path.join(base, "text", "*"))):
        subname = os.path.basename(f)[:-4]
        for line in open(f, encoding="utf-8").read().splitlines():
            wavid = line.split(" ")[0][:-1]
            script = line[len(wavid) + 2:]
            wav_file = os.path.join(base, "wav", subname,
                                    "adr_%s_%s.wav" % (subname, wavid))
            w.add(wav_file, script, "rss", "ro_ro")
    w.finish()


# ---------------------------------------------------------------------------
# nst da/nb (reference corpora/nst.py) — raw big-endian PCM
# ---------------------------------------------------------------------------


def prepare_nst(dataset_path=None, transformed_path=None, langs=("da", "nb")):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    corpora = {"da": "da.talesyntese", "nb": "ibm.talesyntese.nor"}
    for lang_name in langs:
        base = os.path.join(dataset_path, corpora[lang_name])
        if not os.path.isdir(base):
            continue
        if lang_name == "da":
            samples = open(os.path.join(base, "rec_scripts", "baseform_data",
                                        "all_script_orig"),
                           encoding="iso-8859-1").read().splitlines()
            del samples[1751]  # wav 1752 missing in the da corpus
        else:
            samples = open(os.path.join(base, "pcm", "cs", "SCRIPTS",
                                        "CTTS_core.ORIGINAL"),
                           encoding="iso-8859-1").read().splitlines()
            del samples[-1]
        spk = "nst" + lang_name[:2].upper()
        lang = "da_dk" if lang_name == "da" else "nb_no"
        w = CorpusWriter(transformed_path, "nst_" + lang_name)
        for k, line in enumerate(samples):
            if lang_name == "da":
                pcm = os.path.join(base, "all_rec",
                                   "all_script_ca_01_%04d.pcm" % (k + 1))
            else:
                pcm = os.path.join(base, "pcm", "cs",
                                   "ctts_core_cs_01_%04d.pcm" % (k + 1))
            script = line.replace("  ", " ")
            if has_digit(script):
                w.skip()
                continue
            audio = load_raw_pcm16be(pcm)
            w.add(None, script, spk, lang, audio=audio)
        w.finish()


# ---------------------------------------------------------------------------
# hifitts (reference corpora/hifitts.py) — flac manifests
# ---------------------------------------------------------------------------

HIFI_SPEAKER_SUBCORPUS = {"92": "hifi_uk", "6097": "hifi_uk",
                          "9017": "hifi_us"}
HIFI_SPEAKER_NAME = {"92": "CoriSamuel", "6097": "PhilBenson",
                     "9017": "JohnVanStan"}


def prepare_hifitts(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    in_path = os.path.join(dataset_path, "hi_fi_tts_v0", "hi_fi_tts_v0")
    writers = {name: CorpusWriter(transformed_path, name)
               for name in ["hifi_uk", "hifi_us"]}
    for sid, spk_name in HIFI_SPEAKER_NAME.items():
        corpus = HIFI_SPEAKER_SUBCORPUS[sid]
        w = writers[corpus]
        manifest = os.path.join(in_path, sid + "_manifest_clean_train.json")
        for line in open(manifest, encoding="utf-8").read().splitlines():
            sample = json.loads(line)
            flac = os.path.join(in_path,
                                *sample["audio_filepath"].split("/"))
            audio = load_audio(flac, 16000)
            w.add(None, sample["text_normalized"], spk_name,
                  corpus.replace("hifi", "en"), audio=audio)
    for w in writers.values():
        w.rows.sort()
        w.finish()


# ---------------------------------------------------------------------------
# lsru / Russian LibriSpeech (reference corpora/lsru.py)
# ---------------------------------------------------------------------------


def prepare_lsru(dataset_path=None, transformed_path=None):
    dataset_path = dataset_path or default_dataset_path
    transformed_path = transformed_path or default_transformed_path
    in_path = os.path.join(dataset_path, "ruls_data")
    meta_index = {}
    for line in open(os.path.join(in_path, "train", "manifest.json"),
                     encoding="utf-8").read().splitlines():
        m = json.loads(line)
        meta_index[os.path.join(in_path, "train",
                                *m["audio_filepath"].split("/"))] = m
    w = CorpusWriter(transformed_path, "lsru")
    n_spk_skip = 0
    for spk_dir in sorted(glob.glob(os.path.join(in_path, "train", "audio",
                                                 "*"))):
        spk = "LSRU" + os.path.basename(spk_dir)
        wav_files = sorted(glob.glob(os.path.join(spk_dir, "**", "*.wav"),
                                     recursive=True))
        kept = [wf for wf in wav_files if meta_index[wf]["score"] >= -1]
        w.skip(len(wav_files) - len(kept))
        if len(kept) < 100:
            w.skip(len(kept))
            n_spk_skip += 1
            continue
        for wav_file in kept:
            script = meta_index[wav_file]["text_no_preprocessing"]
            if has_ascii_digit(script):
                w.skip()
                continue
            w.add(wav_file, script, spk, "ru_ru")
    w.finish()
    print("%d spk skipped" % n_spk_skip)


ALL_PREPARERS = {
    "ljspeech": prepare_ljspeech,
    "databaker": prepare_databaker,
    "css10": prepare_css10,
    "caito": prepare_caito,
    "google": prepare_google,
    "jsut": prepare_jsut,
    "kss": prepare_kss,
    "siwis": prepare_siwis,
    "thorsten": prepare_thorsten,
    "portuguese": prepare_portuguese,
    "enbible": prepare_enbible,
    "rss": prepare_rss,
    "nst": prepare_nst,
    "hifitts": prepare_hifitts,
    "lsru": prepare_lsru,
}
