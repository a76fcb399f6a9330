"""Training and eval data feeders.

Own copy of ``few_shot_transformer_tts_tpu/data/feeder.py`` (reference
dataloader.py:25-508): a background producer thread with a bounded queue,
language-balanced sampling with temperature 0.2, the adaptation-rate ramp,
data-warmup filtering, speaker exclusion, language downsampling, greedy
quad-limit batch packing, per-rank metadata sharding ([rank::world_size])
with per-rank RNG seeds, and a resumable state dict.

Padded batch shapes are rounded up to the config's lattice (input, target
and batch multiples); rows added by batch padding carry length 0 and drop
out of every masked loss term exactly.

Determinism contract: a feeder seeded with the rank id replays the
reference's RNG draw sequence, so a checkpoint resumed mid-epoch sees the
same data order.  That pins (1) the seed (= rank), (2) the order of the two
__init__ shuffles (training metadata before adaptation metadata), and (3)
the per-example draw order in _next_example (adapt coin first, then the
language choice).  ``load_state_dict`` restores the adapt offset, and a dead
producer thread raises in ``get_batch`` (two reference bugs the JAX package
fixed).  FeederEval reads mel targets from the zip store when given one and
batches texts only without it; an empty eval pool yields no batches.
"""

from __future__ import annotations

import logging
import queue
import sys
import threading
import time
import traceback
from collections import defaultdict
from typing import List

import numpy as np

from ..config import Config
from ..frontend.text import text_to_byte_sequence
from ..utils import tracing
from .metadata import (read_meta, group_meta, downsample_language,
                       filter_eval_samples, speaker_of)
from .zipstore import load_zip


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_FEEDER_ERROR = object()  # queue sentinel: producer thread died


class Feeder(threading.Thread):
    """Training feeder (behavioral parity: reference dataloader.py:25-218)."""

    def __init__(self, zip_filename, metadata_file_path, hparams: Config,
                 spk_to_id=None, lang_to_id=None, rank=0, world_size=1,
                 adapt_lang=None, adapt_spk=None, train_lang=None,
                 train_spk=None, exclude_spk=None, downsample_lang=None,
                 adapt_samples=None, warmup_lang=None, warmup_spk=None):
        super().__init__()
        self.daemon = True
        self._hparams = hparams
        self._spk_to_id = spk_to_id
        self._lang_to_id = lang_to_id
        self._rank = rank
        self._world_size = world_size
        self._warmup_lang = warmup_lang
        self._warmup_spk = warmup_spk
        self.global_step = 1
        self.queue = queue.Queue(maxsize=64)
        # per-rank stream: seed = rank (keeps multi-host shards decorrelated
        # and resumable; matches the reference's seeding)
        self.rand = np.random.RandomState(rank)
        self._lock = threading.Lock()
        self._offset = 0
        self._epoch = 0

        self.zfile = load_zip(zip_filename)

        self._metadata = self._load_rows(
            metadata_file_path, inc_lang=train_lang, inc_spk=train_spk,
            exclude_spk=exclude_spk, downsample_lang=downsample_lang,
            tag="training")
        total_hours = sum(int(r["l"]) for r in self._metadata) * \
            hparams.frame_shift_ms / (3600 * 1000)
        logging.info("Training pool: %d rows, %.2f hours of audio",
                     len(self._metadata), total_hours)

        if self._world_size > 1:
            self._metadata = self._metadata[self._rank::self._world_size]
            logging.info("Rank %d/%d owns %d rows after sharding",
                         self._rank, self._world_size, len(self._metadata))

        # NOTE: this shuffle must stay the rank-RNG's first draw — see the
        # determinism contract in the module docstring.
        if hparams.shuffle_training_data:
            self.rand.shuffle(self._metadata)

        if hparams.balanced_training:
            logging.info("Language-balanced sampling enabled")
            self.grouped_meta = group_meta(self._metadata, hparams)

        self._adapt_lang = adapt_lang
        self._adapt_spk = adapt_spk
        self._adapt_metadata = None
        if adapt_lang or adapt_spk:
            self._init_adapt_pool(metadata_file_path, adapt_lang, adapt_spk,
                                  exclude_spk, adapt_samples, downsample_lang)

    def _load_rows(self, path, inc_lang, inc_spk, exclude_spk,
                   downsample_lang, tag):
        """Read + filter a metadata file; logs each filter's surviving count
        (operators use these lines to sanity-check split sizes)."""
        with open(path, encoding="utf-8") as f:
            rows = read_meta(f, self._hparams.data_format,
                             inc_lang=inc_lang, inc_spk=inc_spk)
        logging.info("Read %d %s rows from %s", len(rows), tag, path)
        if exclude_spk:
            rows = [r for r in rows if speaker_of(r["n"]) not in exclude_spk]
            logging.info("%d %s rows after dropping excluded speakers",
                         len(rows), tag)
        if downsample_lang:
            rows = downsample_language(rows, downsample_lang)
            logging.info("%d %s rows after downsampling languages",
                         len(rows), tag)
        return rows

    def _init_adapt_pool(self, metadata_file_path, adapt_lang, adapt_spk,
                         exclude_spk, adapt_samples, downsample_lang):
        """Few-shot adaptation pool: a second metadata read restricted to the
        adaptation languages/speakers, mixed in by _next_example at the
        ramping rate (reference dataloader.py:76-103,175-179)."""
        rows = self._load_rows(
            metadata_file_path, inc_lang=adapt_lang, inc_spk=adapt_spk,
            exclude_spk=exclude_spk,
            # an explicit sample list overrides downsampling
            downsample_lang=None if adapt_samples else downsample_lang,
            tag="adaptation")
        if adapt_samples:
            rows = [r for r in rows if r["n"] in adapt_samples]

        per_spk_count = defaultdict(int)
        per_spk_minutes = defaultdict(float)
        for r in rows:
            spk = speaker_of(r["n"])
            per_spk_count[spk] += 1
            per_spk_minutes[spk] += \
                int(r["l"]) * self._hparams.frame_shift_ms / (60 * 1000)
        logging.info("Adaptation pool by speaker: %s", " ".join(
            "%s=%d rows/%.3f min" % (spk, n, per_spk_minutes[spk])
            for spk, n in per_spk_count.items()))

        if self._world_size > 1:
            rows = rows[self._rank::self._world_size]
            logging.info("Rank %d owns %d adaptation rows after sharding",
                         self._rank, len(rows))
        if len(rows) <= 30:
            logging.info("Adaptation rows: %s",
                         ", ".join(r["n"] for r in rows))
        self._adapt_metadata = rows
        self._adapt_offset = 0
        self.rand.shuffle(self._adapt_metadata)

    # ---------------- producer thread ---------------------------------------

    def run(self):
        try:
            while True:
                self._enqueue_next_group()
        except Exception:
            logging.error(traceback.format_exc())
            # propagate to the consumer instead of stalling get_batch forever
            self._error = sys.exc_info()[1]
            self.queue.put(_FEEDER_ERROR)

    def get_batch(self):
        """The next packed batch; counts its target frames and its padding
        (``data.frames``, ``data.padded_frames``)."""
        with tracing.span("data.get_batch"):
            batch = self.queue.get()
            if batch is _FEEDER_ERROR:
                raise RuntimeError("Feeder thread failed: %r" % self._error)
            mel = batch.get("mel_targets")
            if mel is not None:
                frames = int(np.sum(batch["target_lengths"]))
                tracing.count("data.frames", frames)
                tracing.count("data.padded_frames",
                              mel.shape[0] * mel.shape[1] - frames)
            return batch

    # ---------------- resumable state ----------------------------------------

    def state_dict(self):
        with self._lock:
            state = {"rand": self.rand.get_state()}
            if self._hparams.balanced_training:
                # copies, not live references: the producer keeps mutating
                # the cursors while the checkpoint write is in flight
                state["offset"] = dict(self.grouped_meta["offsets"])
                state["epoch"] = dict(self.grouped_meta["epoch"])
            else:
                state["offset"] = self._offset
                state["epoch"] = self._epoch
            if hasattr(self, "_adapt_offset"):
                state["adapt_offset"] = self._adapt_offset
            logging.info("Feeder state captured at offsets %s",
                         str(state["offset"]))
            return state

    def load_state_dict(self, state):
        logging.info("Feeder state restored to offsets %s",
                     str(state["offset"]))
        with self._lock:
            self.rand.set_state(state["rand"])
            if self._hparams.balanced_training:
                self.grouped_meta["offsets"].update(state["offset"])
                self.grouped_meta["epoch"].update(state["epoch"])
            else:
                self._offset = state["offset"]
                self._epoch = state["epoch"]
            if hasattr(self, "_adapt_offset") and "adapt_offset" in state:
                self._adapt_offset = state["adapt_offset"]

    # ---------------- sampling ----------------------------------------------

    def get_examples(self, bucket_size: int) -> List[dict]:
        with self._lock:
            return [self._next_example() for _ in range(bucket_size)]

    def _enqueue_next_group(self):
        tic = time.time()
        examples = self.get_examples(self._hparams.bucket_size)
        examples.sort(key=lambda x: len(x["mel_target"]))
        batches = _pack_into_batches(examples, hparams=self._hparams)
        self.rand.shuffle(batches)
        for batch in batches:
            self.queue.put(_prepare_batch(batch, hparams=self._hparams,
                                          pad_to_lattice=True))
        logging.info("Bucket of %d examples -> %d packed batches (%.2f sec)",
                     len(examples), len(batches), time.time() - tic)

    def _next_balanced_row(self):
        g = self.grouped_meta
        lang = self.rand.choice(g["langs"], p=g["prob"])
        row = g["meta"][lang][g["offsets"][lang]]
        g["offsets"][lang] += 1
        if g["offsets"][lang] >= len(g["meta"][lang]):
            g["offsets"][lang] = 0
            g["epoch"][lang] += 1
            logging.info("Language %s entering epoch %d", lang,
                         g["epoch"][lang])
        return row

    def _next_sequential_row(self):
        row = self._metadata[self._offset]
        self._offset += 1
        if self._offset >= len(self._metadata):
            self._offset = 0
            self._epoch += 1
            if self._hparams.shuffle_training_data:
                self.rand.shuffle(self._metadata)
        return row

    def _next_adapt_row(self):
        row = self._adapt_metadata[self._adapt_offset]
        self._adapt_offset += 1
        if self._adapt_offset >= len(self._adapt_metadata):
            self._adapt_offset = 0
            self.rand.shuffle(self._adapt_metadata)
        return row

    def _next_example(self):
        while True:
            # draw order is part of the determinism contract: adapt coin
            # first, then the (balanced) language choice
            if self._adapt_metadata and self.rand.random() < self._adapt_rate():
                row = self._next_adapt_row()
            elif self._hparams.balanced_training:
                row = self._next_balanced_row()
            else:
                row = self._next_sequential_row()
            if not self.skip_meta(row):
                return extract_meta(row, self.zfile, self._hparams,
                                    self._spk_to_id, self._lang_to_id)

    def _adapt_rate(self) -> float:
        """Adaptation mixing probability, ramping linearly 0 ->
        final_adapt_rate over [adapt_start_step, adapt_end_step]."""
        hp = self._hparams
        if self.global_step >= hp.adapt_end_step:
            ramp = 1.0
        elif self.global_step < hp.adapt_start_step:
            ramp = 0.0
        else:
            ramp = (self.global_step - hp.adapt_start_step) / \
                (hp.adapt_end_step - hp.adapt_start_step)
        return ramp * hp.final_adapt_rate

    def skip_meta(self, row) -> bool:
        """Data-warmup gate: before data_warmup_steps only warmup
        languages/speakers and mid-length targets are admitted."""
        hp = self._hparams
        if self.global_step >= hp.data_warmup_steps:
            return False
        if self._warmup_lang is not None and \
                row.get("i", None) not in self._warmup_lang:
            return True
        if self._warmup_spk is not None and \
                speaker_of(row["n"]) not in self._warmup_spk:
            return True
        if hp.target_length_upper_bound < 0 or \
                hp.target_length_lower_bound <= int(row["l"]) <= \
                hp.target_length_upper_bound:
            return False
        return True


class FeederEval:
    """Eval feeder (behavioral parity: reference dataloader.py:221-310).
    Eager; supports a no-zip synthesis-only mode where only texts are
    batched."""

    def __init__(self, zip_filename, metadata_file_path, hparams: Config,
                 spk_to_id=None, lang_to_id=None, eval_lang=None,
                 eval_spk=None, exclude_spk=None, target_lang=None,
                 target_spk=None, shuffle=True, keep_order=False,
                 pick_partial=False, single=False):
        self._offset = 0
        self._shuffle = shuffle
        self._keep_order = keep_order
        self.single = single
        self.lang_ids = lang_to_id
        self.spk_ids = spk_to_id
        self._target_lang = target_lang
        self._target_spk = target_spk
        self._eval_lang = eval_lang
        self._eval_spk = eval_spk
        self._hparams = hparams

        self.zfile = load_zip(zip_filename) if zip_filename is not None \
            else None

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
        self._meta_texts = ["|".join(m[c] for c in hparams.data_format)
                            for m in self._metadata]

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
        return extract_meta(meta, self.zfile, self._hparams, self.spk_ids,
                            self.lang_ids, target_spk=self._target_spk,
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
        if self._shuffle and examples and "mel_target" in examples[0]:
            examples.sort(key=lambda x: len(x["mel_target"]))
        return _pack_into_batches(examples, self.single,
                                  hparams=self._hparams)

    def prepare_all_batches(self, batches):
        return [_prepare_batch(b, hparams=self._hparams) for b in batches]


# ---------------------------------------------------------------------------
# packing / batching
# ---------------------------------------------------------------------------


def _pack_into_batches(examples, single=False, hparams: Config = None):
    """Greedy packing under two budgets (reference dataloader.py:401-410):
    total padded frames <= batch_frame_limit, and the quadratic attention
    proxy B * (max_in^2 + max_tgt^2) <= batch_frame_quad_limit.

    ``examples`` arrive length-sorted, so each batch's padded shape tracks its
    own contents; without a mel target the target length is estimated at
    1.5x the input length (synthesis-only mode).
    """
    batches, current = [], []
    cur_max_in = 0
    for ex in examples:
        t_in = len(ex["input"])
        t_tgt = len(ex["mel_target"]) if "mel_target" in ex \
            else int(t_in * 1.5)
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


def _prepare_batch(batch, hparams: Config, pad_to_lattice: bool = False) -> dict:
    """Pad a packed batch into dense arrays.

    With pad_to_lattice, padded dims are rounded up to the config's shape
    lattice and padded rows carry zero lengths (masked out of the loss)."""
    in_mult = hparams.input_length_multiple if pad_to_lattice else 1
    tgt_mult = hparams.target_length_multiple if pad_to_lattice else 1
    b_mult = hparams.batch_size_multiple if pad_to_lattice else 1

    b = len(batch)
    b_pad = _round_up(b, b_mult)
    max_in = _round_up(max(len(x["input"]) for x in batch), in_mult)

    inputs = np.zeros((b_pad, max_in), dtype=np.int32)
    input_lengths = np.zeros((b_pad,), dtype=np.int32)
    for i, x in enumerate(batch):
        inputs[i, :len(x["input"])] = x["input"]
        input_lengths[i] = len(x["input"])
    results = {"inputs": inputs, "input_lengths": input_lengths}

    if "target_length" in batch[0]:
        target_lengths = np.zeros((b_pad,), dtype=np.int32)
        target_lengths[:b] = [x["target_length"] for x in batch]
        results["target_lengths"] = target_lengths
    elif "mel_target" in batch[0]:
        target_lengths = np.zeros((b_pad,), dtype=np.int32)
        target_lengths[:b] = [len(x["mel_target"]) for x in batch]
        results["target_lengths"] = target_lengths
    if "mel_target" in batch[0]:
        max_tgt = _round_up(max(len(x["mel_target"]) for x in batch), tgt_mult)
        mel = np.zeros((b_pad, max_tgt, batch[0]["mel_target"].shape[1]),
                       dtype=np.float32)
        for i, x in enumerate(batch):
            mel[i, :len(x["mel_target"])] = x["mel_target"]
        results["mel_targets"] = mel

    if hparams.multi_lingual:
        lvec = np.zeros((b_pad, hparams.max_num_language), dtype=np.float32)
        for i, x in enumerate(batch):
            lvec[i] = x["language_vec"]
        results["input_language_vecs"] = lvec
    if hparams.multi_speaker or hparams.multi_lingual:
        spk = np.zeros((b_pad,), dtype=np.int32)
        spk[:b] = [x["speaker_id"] for x in batch]
        results["input_spk_ids"] = spk
    results["names"] = [x["name"] for x in batch]
    results["num_valid"] = b
    return results


def extract_meta(meta: dict, zfile, hparams: Config, spk_ids, lang_ids,
                 target_spk=None, target_lang=None) -> dict:
    """One metadata row -> example dict: byte ids from the text, the mel from
    the zip store (when present), one-hot language vector, speaker id."""
    name = meta["n"]
    if name.endswith(".npy"):
        name = name[:-4]
    example = {"name": name,
               "input": np.asarray(
                   text_to_byte_sequence(meta["t"], use_sos=hparams.use_sos),
                   dtype=np.int32)}

    if zfile is not None:
        mel = zfile.read_npy(meta["n"])
        example["mel_target"] = mel
        example["target_length"] = int(meta["l"]) if "l" in meta \
            else mel.shape[0]

    lang = target_lang if target_lang is not None else meta.get("i", None)
    if hparams.multi_lingual and lang:
        onehot = np.zeros([hparams.max_num_language], dtype=np.float32)
        onehot[lang_ids[lang]] = 1
        example["language_vec"] = onehot

    if hparams.multi_speaker or hparams.multi_lingual:
        example["speaker_id"] = spk_ids[target_spk if target_spk
                                        else speaker_of(name)]
    return example
