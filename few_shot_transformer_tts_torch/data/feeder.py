"""Synthesis-only eval feeder.

Own copy of ``FeederEval``, ``_pack_into_batches``, ``_prepare_batch`` and
``extract_meta`` from ``few_shot_transformer_tts_tpu/data/feeder.py``
(reference dataloader.py:221-310, 401-508), in the no-zip mode where only
texts are batched.  The mel zip store comes with the training slice; until
then a zip path raises.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np

from ..config import Config
from ..frontend.text import text_to_byte_sequence
from .metadata import read_meta, filter_eval_samples, speaker_of


class FeederEval:
    """Eval feeder (behavioral parity: reference dataloader.py:221-310),
    synthesis-only: ``zip_filename`` must be None."""

    def __init__(self, zip_filename, metadata_file_path, hparams: Config,
                 spk_to_id=None, lang_to_id=None, eval_lang=None,
                 eval_spk=None, exclude_spk=None, target_lang=None,
                 target_spk=None, shuffle=True, keep_order=False,
                 pick_partial=False, single=False):
        if zip_filename is not None:
            raise NotImplementedError(
                "FeederEval reads mel targets from a zip store, which the "
                "port does not have yet; pass zip_filename=None for "
                "synthesis-only batches")
        self._offset = 0
        self._shuffle = shuffle
        self._keep_order = keep_order
        self.single = single
        self.lang_ids = lang_to_id
        self.spk_ids = spk_to_id
        self._target_lang = target_lang
        self._target_spk = target_spk
        self._hparams = hparams

        with open(metadata_file_path, encoding="utf-8") as f:
            self._metadata = read_meta(f, hparams.data_format,
                                       inc_lang=eval_lang, inc_spk=eval_spk)
        logging.info("Eval pool: read %d rows", len(self._metadata))

        if "l" in hparams.data_format:
            self._metadata = [m for m in self._metadata
                              if int(m["l"]) < hparams.max_eval_sample_length]
            logging.info("Eval pool: %d rows under the length cap",
                         len(self._metadata))
        if exclude_spk:
            self._metadata = [m for m in self._metadata
                              if speaker_of(m["n"]) not in exclude_spk]
            logging.info("Eval pool: %d rows after dropping excluded speakers",
                         len(self._metadata))
        if pick_partial:
            self._metadata = filter_eval_samples(
                self._metadata, 3, hparams.eval_sample_per_speaker)
            logging.info("Eval pool: %d rows after per-speaker subsetting",
                         len(self._metadata))

        self.data = self.prepare_all_batches(self.get_all_batches())
        self.rand = np.random.RandomState(0)
        if self._shuffle:
            self.rand.shuffle(self.data)
        logging.info("Eval pool: prepared %d batches", len(self.data))

    def fetch_data(self, exclude=None) -> List[dict]:
        if exclude is None:
            data = self.data
        else:
            data = self.prepare_all_batches(self.get_all_batches(exclude))
        if self._shuffle and not self._keep_order:
            self.rand.shuffle(data)
        return data

    def _get_next_example(self):
        finished = False
        meta = self._metadata[self._offset]
        self._offset += 1
        if self._offset >= len(self._metadata):
            self._offset = 0
            finished = True
        return extract_meta(meta, self._hparams, self.spk_ids, self.lang_ids,
                            target_spk=self._target_spk,
                            target_lang=self._target_lang), finished

    def _get_all_examples(self):
        examples = []
        while self._metadata:
            example, finished = self._get_next_example()
            examples.append(example)
            if finished:
                break
        return examples

    def get_all_batches(self, exclude=()):
        examples = self._get_all_examples()
        examples = [x for x in examples if x["name"] not in exclude]
        return _pack_into_batches(examples, self.single,
                                  hparams=self._hparams)

    def prepare_all_batches(self, batches):
        return [_prepare_batch(b, hparams=self._hparams) for b in batches]


def _pack_into_batches(examples, single=False, hparams: Config = None):
    """Greedy packing under two budgets (reference dataloader.py:401-410):
    total padded frames <= batch_frame_limit, and the quadratic attention
    proxy B * (max_in^2 + max_tgt^2) <= batch_frame_quad_limit.  Without a
    mel target the target length is estimated at 1.5x the input length."""
    batches, current = [], []
    cur_max_in = 0
    for ex in examples:
        t_in = len(ex["input"])
        t_tgt = int(t_in * 1.5)
        new_max_in = max(cur_max_in, t_in)
        quad = new_max_in ** 2 + t_tgt ** 2
        n = len(current) + 1
        if current and (single or n * t_tgt > hparams.batch_frame_limit or
                        n * quad > hparams.batch_frame_quad_limit):
            batches.append(current)
            current, new_max_in = [], t_in
        current.append(ex)
        cur_max_in = new_max_in
    if current:
        batches.append(current)
    return batches


def _prepare_batch(batch, hparams: Config) -> dict:
    """Pad a packed batch of texts into dense arrays."""
    b = len(batch)
    max_in = max(len(x["input"]) for x in batch)

    inputs = np.zeros((b, max_in), dtype=np.int32)
    input_lengths = np.zeros((b,), dtype=np.int32)
    for i, x in enumerate(batch):
        inputs[i, :len(x["input"])] = x["input"]
        input_lengths[i] = len(x["input"])
    results = {"inputs": inputs, "input_lengths": input_lengths}

    if hparams.multi_lingual:
        lvec = np.zeros((b, hparams.max_num_language), dtype=np.float32)
        for i, x in enumerate(batch):
            lvec[i] = x["language_vec"]
        results["input_language_vecs"] = lvec
    if hparams.multi_speaker or hparams.multi_lingual:
        spk = np.zeros((b,), dtype=np.int32)
        spk[:] = [x["speaker_id"] for x in batch]
        results["input_spk_ids"] = spk
    results["names"] = [x["name"] for x in batch]
    results["num_valid"] = b
    return results


def extract_meta(meta: dict, hparams: Config, spk_ids, lang_ids,
                 target_spk=None, target_lang=None) -> dict:
    """One metadata row -> example dict: byte ids from the text, one-hot
    language vector, speaker id."""
    name = meta["n"]
    if name.endswith(".npy"):
        name = name[:-4]
    example = {"name": name,
               "input": np.asarray(
                   text_to_byte_sequence(meta["t"], use_sos=hparams.use_sos),
                   dtype=np.int32)}

    lang = target_lang if target_lang is not None else meta.get("i", None)
    if hparams.multi_lingual and lang:
        onehot = np.zeros([hparams.max_num_language], dtype=np.float32)
        onehot[lang_ids[lang]] = 1
        example["language_vec"] = onehot

    if hparams.multi_speaker or hparams.multi_lingual:
        example["speaker_id"] = spk_ids[target_spk if target_spk
                                        else speaker_of(name)]
    return example
