"""A training batch worked out again from the corpus the benchmark wrote.

Given the names of a batch's utterances, ``padded_batch`` reads their mels
from the corpus zip (Python's ``zipfile``) and their texts, languages and
speakers from the corpus' metadata, and pads them as the data format of
the reference implementation and its JAX port prescribe: text as UTF-8
bytes between a start id (2) and an end id (1); every axis padded with
zeros up to the shape lattice (input length, target length and row count
rounded up to their multiples); rows added by the padding have length 0;
a one-hot language vector and an integer speaker id per row.  With
``wire_mel_int16`` the mels take the int16 host-to-device copy's values:
round(clip(m * 32767 / max_abs, -32767, 32767)) * max_abs / 32767.

``batch_faults`` counts how a packed batch of the program departs from it.
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np


def _up(x, m):
    return -(-x // m) * m


class Corpus:
    """The corpus directory the train mix wrote: ``mels.zip``,
    ``metadata.train.txt`` (name|frames|text|language), ``spk_id.json``,
    ``lang_id.json``."""

    def __init__(self, root):
        self.zip = os.path.join(root, "mels.zip")
        self.rows = {}
        with open(os.path.join(root, "metadata.train.txt"),
                  encoding="utf-8") as f:
            for line in f:
                name, frames, text, lang = line.rstrip("\n").split("|")
                self.rows[name[:-4]] = (int(frames), text, lang)
        with open(os.path.join(root, "spk_id.json")) as f:
            self.spk = json.load(f)
        with open(os.path.join(root, "lang_id.json")) as f:
            self.lang = json.load(f)

    def mels(self, names):
        with zipfile.ZipFile(self.zip) as zf:
            return [np.load(io.BytesIO(zf.read(n + ".npy"))) for n in names]


def padded_batch(corpus: Corpus, names, hp) -> dict:
    rows = [corpus.rows[n] for n in names]
    mels = corpus.mels(names)
    texts = [[2] + list(text.encode("utf-8")) + [1] for _, text, _ in rows]
    b = len(names)
    bp = _up(b, hp.batch_size_multiple)
    ti = _up(max(len(t) for t in texts), hp.input_length_multiple)
    to = _up(max(len(m) for m in mels), hp.target_length_multiple)
    out = {"inputs": np.zeros((bp, ti), np.int32),
           "input_lengths": np.zeros(bp, np.int32),
           "mel_targets": np.zeros((bp, to, hp.num_mels), np.float32),
           "target_lengths": np.zeros(bp, np.int32)}
    for i, (t, m, (frames, _, _)) in enumerate(zip(texts, mels, rows)):
        out["inputs"][i, :len(t)] = t
        out["input_lengths"][i] = len(t)
        out["mel_targets"][i, :len(m)] = m
        out["target_lengths"][i] = frames
    if hp.wire_mel_int16:
        scale = 32767.0 / hp.max_abs_value
        q = np.round(np.clip(out["mel_targets"] * scale, -32767, 32767))
        out["mel_targets"] = q.astype(np.int16).astype(np.float32) * \
            np.float32(hp.max_abs_value / 32767.0)
    if hp.multi_lingual:
        lvec = np.zeros((bp, hp.max_num_language), np.float32)
        for i, (_, _, lang) in enumerate(rows):
            lvec[i, corpus.lang[lang]] = 1.0
        out["input_language_vecs"] = lvec
    if hp.multi_speaker or hp.multi_lingual:
        spk = np.zeros(bp, np.int32)
        for i, n in enumerate(names):
            spk[i] = corpus.spk[n.split("_")[0]]
        out["input_spk_ids"] = spk
    return out


def batch_faults(program: dict, expected: dict, hp) -> list:
    """What differs between the program's packed batch (host arrays of
    what went to the device) and the expected one, and which packing rule
    the batch breaks: sorted rows, the frame budget, the quadratic
    budget."""
    faults = []
    for key, want in expected.items():
        got = program.get(key)
        if got is None or got.shape != want.shape:
            faults.append("%s shape %s, expected %s" % (
                key, None if got is None else got.shape, want.shape))
        elif not np.array_equal(got, want):
            faults.append("%s differs at %d elements" % (
                key, int(np.sum(got != want))))
    tl = expected["target_lengths"]
    il = expected["input_lengths"]
    n = int(np.sum(tl > 0))
    if np.any(np.diff(tl[:n]) < 0):
        faults.append("rows not sorted by length")
    if n > 1:
        t_max, i_max = int(tl[:n].max()), int(il[:n].max())
        if n * t_max > hp.batch_frame_limit:
            faults.append("frame budget exceeded")
        if n * (i_max ** 2 + t_max ** 2) > hp.batch_frame_quad_limit:
            faults.append("quadratic budget exceeded")
    return faults
