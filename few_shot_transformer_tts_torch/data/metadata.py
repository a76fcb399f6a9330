"""Metadata parsing and eval filtering for synthesis.

Own copy of the parts of ``few_shot_transformer_tts_tpu/data/metadata.py``
that FeederEval needs (reference dataloader.py:313-398).  Rows are
``name|n_frames|text|lang`` ('nlti') or ``name|n_frames|text|phones|lang``
('nltpi'), '|' or tab separated; the speaker id is the name's prefix before
'_'.  ``filter_eval_samples`` shuffles each language's rows with a fresh
seed-0 RandomState, so the surviving subset is a pure function of the file.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

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
