"""Metadata parsing, language grouping, downsampling, eval filtering.

Own copy of ``few_shot_transformer_tts_tpu/data/metadata.py`` (reference
dataloader.py:313-398).  Rows are ``name|n_frames|text|lang`` ('nlti') or
``name|n_frames|text|phones|lang`` ('nltpi'), '|' or tab separated; the
speaker id is the name's prefix before '_'.  ``downsample_language`` and
``filter_eval_samples`` shuffle each language's rows with a fresh seed-0
RandomState, so the surviving subset is a pure function of the file.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def speaker_of(name: str) -> str:
    return name.split("_")[0]


_KNOWN_FORMATS = ("nlti", "nltpi")


def read_meta(meta_file, fmt: str, inc_lang=None, inc_spk=None) -> List[dict]:
    """Parse metadata lines into row dicts keyed by the format characters
    (n=name, l=n_frames, t=text, p=phones, i=language), optionally keeping
    only the given languages/speakers."""
    if fmt not in _KNOWN_FORMATS:
        raise ValueError("Invalid format for read_meta: %s" % fmt)
    rows = []
    for line in meta_file:
        line = line.strip()
        if not line:
            continue
        fields = line.split("|")
        if len(fields) != len(fmt):
            fields = line.split("\t")
        if len(fields) != len(fmt):
            raise ValueError("Metadata row has %d fields, format %r needs %d: "
                             "%r" % (len(fields), fmt, len(fmt), line))
        row = dict(zip(fmt, fields))
        if inc_lang is not None and row["i"] not in inc_lang:
            continue
        if inc_spk is not None and speaker_of(row["n"]) not in inc_spk:
            continue
        rows.append(row)
    return rows


def group_meta(metadata: List[dict], hp) -> Dict:
    """Bucket rows by language and attach temperature-scaled sampling
    probabilities, prob ~ (n_lang / n_total) ** lg_prob_scale.

    The returned dict drives the balanced sampler: per-language row lists plus
    mutable cursor ('offsets') and epoch counters, which round-trip through
    Feeder.state_dict.
    """
    by_lang: Dict[str, list] = defaultdict(list)
    for row in metadata:
        by_lang[row["i"]].append(row)
    langs = sorted(by_lang)
    counts = np.asarray([len(by_lang[lang]) for lang in langs], np.float64)
    scaled = np.power(counts / counts.sum(), hp.lg_prob_scale)
    prob = scaled / scaled.sum()
    for lang, n, p in zip(langs, counts, prob):
        speakers = sorted({speaker_of(r["n"]) for r in by_lang[lang]})
        logging.info("\t%s: %d samples, prob=%f", lang, int(n), p)
        logging.info("\tSpeakers: %s", str(speakers))
    return {"langs": langs, "prob": prob, "meta": dict(by_lang),
            "offsets": {lang: 0 for lang in langs},
            "epoch": {lang: 0 for lang in langs}}


def downsample_language(meta_list: List[dict],
                        downsample_langs: Dict[str, float]) -> List[dict]:
    """Reduce each listed language to a ratio (spec <= 1) or an absolute
    count (spec > 1) of its rows, selected by a seed-0 shuffle of the row
    positions; unlisted languages pass through untouched."""
    per_lang_positions: Dict[str, list] = defaultdict(list)
    for pos, row in enumerate(meta_list):
        if row["i"] in downsample_langs:
            per_lang_positions[row["i"]].append(pos)

    dropped = set()
    for lang, positions in per_lang_positions.items():
        np.random.RandomState(0).shuffle(positions)
        spec = downsample_langs[lang]
        n_keep = int(len(positions) * spec) if spec <= 1 else int(spec)
        dropped.update(positions[n_keep:])
    return [row for pos, row in enumerate(meta_list) if pos not in dropped]


def filter_eval_samples(meta: List[dict], n_spk: int,
                        n_sample: int) -> List[dict]:
    """Per language keep at most ``n_spk`` speakers x ``n_sample`` rows each,
    walking a seed-0 shuffle of that language's rows (so the picked speakers
    are the first distinct ones encountered).  The combined result is seed-0
    shuffled again."""
    by_lang: Dict[str, list] = defaultdict(list)
    for row in meta:
        by_lang[row["i"]].append(row)

    picked = []
    for rows in by_lang.values():
        np.random.RandomState(0).shuffle(rows)
        quota = {}
        for row in rows:
            spk = speaker_of(row["n"])
            if spk not in quota:
                if len(quota) >= n_spk:
                    continue
                quota[spk] = 0
            quota[spk] += 1
            if quota[spk] <= n_sample:
                picked.append(row)
    np.random.RandomState(0).shuffle(picked)
    return picked


def parse_downsample_spec(spec: Optional[str]) -> Dict[str, float]:
    """CLI form LANG:RATIO_OR_N[,LANG:R...] (reference train.py:96-101)."""
    if not spec:
        return {}
    out = {}
    for part in spec.split(","):
        lang, r = part.split(":")
        out[lang] = float(r)
    return out
