"""The one generator of traffic: every mix file's parameters become inputs
here, from the run's seed.

Sizes are stratified so that every seed gets the same set of sizes in
another order: a draw of n lengths from [lo, hi] takes one length from each
of n equal strata of the range, and the order is shuffled.  Text is
lowercase ASCII letters and spaces; a text of n bytes is n + 2 ids with the
start (2) and end (1) ids.

  train        ``write_corpus``: a packed corpus (``mels.zip`` of float32
               .npy mels, ``metadata.train.txt``, ``spk_id.json``,
               ``lang_id.json``) of ``utterances`` rows, target frames on a
               fixed grid over ``target_frames``, text of ``frames x
               bytes_per_frame x (1 +- bytes_jitter)`` bytes, mel values
               uniform in ``mel_range``, languages and speakers spread
               evenly over the configuration's tables
  batch_synth  ``synth_batches``: batches of ``batch`` rows, text bytes
               stratified over ``input_bytes``, a language and a speaker
               drawn per row
  utterance    ``utterances``: one-row requests, text bytes stratified over
               ``input_bytes`` in blocks of ``stratum_block``, each with a
               frame cap of ``frames_per_byte`` x bytes rounded up to
               ``frame_round``
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import torch

from .weights import generator

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def strata(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n integers in [lo, hi], one from each of n equal strata, shuffled."""
    edges = lo + (hi - lo + 1) * np.arange(n + 1) / n
    out = np.floor(edges[:-1] + rng.random(n) * (edges[1:] - edges[:-1]))
    return rng.permutation(np.clip(out, lo, hi).astype(np.int64))


def text(n: int, rng) -> bytes:
    """n bytes of letters with about one space in six, letters at the
    ends."""
    b = _LETTERS[rng.integers(0, 26, n)]
    spaces = rng.random(n) < 1 / 6
    spaces[[0, -1]] = False
    b[spaces] = ord(" ")
    return b.tobytes()


def ids(t: bytes) -> list:
    return [2] + list(t) + [1]


def _rng(seed: int, tag: int):
    return np.random.default_rng([seed, tag])


def _conditioning(hp, b, rng, out):
    if hp.multi_lingual:
        lvec = np.zeros((b, hp.max_num_language), np.float32)
        lvec[np.arange(b), rng.integers(0, hp.max_num_language, b)] = 1.0
        out["input_language_vecs"] = lvec
    if hp.multi_speaker:
        out["input_spk_ids"] = rng.integers(
            0, hp.max_num_speaker, b).astype(np.int32)


def _batch(texts, hp, rng) -> dict:
    rows = [ids(t) for t in texts]
    b, t = len(rows), max(len(r) for r in rows)
    inputs = np.zeros((b, t), np.int32)
    for i, r in enumerate(rows):
        inputs[i, :len(r)] = r
    out = {"inputs": inputs,
           "input_lengths": np.asarray([len(r) for r in rows], np.int32),
           "names": ["row%d" % i for i in range(b)]}
    _conditioning(hp, b, rng, out)
    return out


def synth_batches(mix, hp, seed: int, count: int) -> list:
    rng = _rng(seed, 4)
    lo, hi = mix["input_bytes"]
    return [_batch([text(int(n), rng) for n in
                    strata(lo, hi, mix["batch"], rng)], hp, rng)
            for _ in range(count)]


def frame_cap(n_bytes: int, mix) -> int:
    r = mix["frame_round"]
    return -(-int(np.ceil(n_bytes * mix["frames_per_byte"])) // r) * r


def utterances(mix, hp, seed: int, count: int) -> list:
    """[(one-row batch, frame cap)]."""
    rng = _rng(seed, 5)
    lo, hi = mix["input_bytes"]
    block = mix["stratum_block"]
    sizes = np.concatenate([strata(lo, hi, block, rng)
                            for _ in range(-(-count // block))])[:count]
    return [(_batch([text(int(n), rng)], hp, rng), frame_cap(int(n), mix))
            for n in sizes]


def write_corpus(mix, hp, seed: int, root: str, device) -> str:
    """Write the train mix's corpus under ``root``; returns ``root``."""
    n = mix["utterances"]
    lo, hi = mix["target_frames"]
    i = np.arange(n)
    frames = lo + np.floor((i + 0.5) * (hi - lo + 1) / n).astype(np.int64)
    jitter = mix["bytes_jitter"] * (2 * ((i * 0.6180339887498949) % 1) - 1)
    n_bytes = np.maximum(1, np.round(
        frames * mix["bytes_per_frame"] * (1 + jitter))).astype(np.int64)
    rng = _rng(seed, 2)
    order = rng.permutation(n)
    frames, n_bytes = frames[order], n_bytes[order]
    langs = rng.permutation(i % (hp.max_num_language if hp.multi_lingual
                                 else 1))
    spks = rng.permutation(i % (hp.max_num_speaker if hp.multi_speaker
                                else 1))
    lo_v, hi_v = mix["mel_range"]
    total = int(frames.sum()) * hp.num_mels
    mel = (torch.rand(total, generator=generator(seed, 3, device),
                      device=device) * (hi_v - lo_v) + lo_v).cpu().numpy()
    os.makedirs(root, exist_ok=True)
    meta, at = [], 0
    with zipfile.ZipFile(os.path.join(root, "mels.zip"), "w",
                         zipfile.ZIP_STORED) as zf:
        for k in range(n):
            name = "s%04d_%06d.npy" % (spks[k], k)
            size = int(frames[k]) * hp.num_mels
            arr = mel[at:at + size].reshape(int(frames[k]), hp.num_mels)
            at += size
            buf = io.BytesIO()
            np.lib.format.write_array(buf, arr, allow_pickle=False)
            zf.writestr(name, buf.getvalue())
            meta.append("%s|%d|%s|l%02d" % (
                name, frames[k], text(int(n_bytes[k]), rng).decode(),
                langs[k]))
    with open(os.path.join(root, "metadata.train.txt"), "w") as f:
        f.write("\n".join(meta) + "\n")
    with open(os.path.join(root, "spk_id.json"), "w") as f:
        json.dump({"s%04d" % s: int(s) for s in sorted(set(spks))}, f)
    with open(os.path.join(root, "lang_id.json"), "w") as f:
        json.dump({"l%02d" % g: int(g) for g in sorted(set(langs))}, f)
    return root
