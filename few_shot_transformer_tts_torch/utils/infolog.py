"""Logging, plots, metric windows and the scalar writer; own copy of
``set_logger``, ``plot_mel``, ``plot_attn``, ``ValueWindow``,
``LookupWindow`` and ``MetricWriter`` from ``few_shot_transformer_tts_tpu/
utils/infolog.py`` (reference utils/infolog.py:16-127).

matplotlib is optional: where it is missing, the plots are skipped with one
logged warning, and the ``.npy``/``.wav`` outputs are written all the same.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import defaultdict
from threading import Lock

import numpy as np

lock = Lock()
_warned = []


def set_logger(output_path=None, name=None):
    """stdout + optional file logger (reference utils/infolog.py:16-37)."""
    fmt = logging.Formatter(
        "[" + (name + " " if name else "") + "%(levelname)s %(asctime)s] %(message)s")
    handlers = []
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(fmt)
    h.setLevel(logging.INFO)
    handlers.append(h)
    if output_path is not None:
        h = logging.FileHandler(output_path, "a", "utf-8")
        h.setFormatter(fmt)
        h.setLevel(logging.INFO)
        handlers.append(h)
    while logging.root.hasHandlers() and logging.root.handlers:
        logging.root.removeHandler(logging.root.handlers[0])
    logging.root.setLevel(logging.INFO)
    for h in handlers:
        logging.root.addHandler(h)


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None (warned once)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except ImportError:
        with lock:
            if not _warned:
                _warned.append(True)
                logging.warning("matplotlib is not installed: mel and "
                                "alignment plots are skipped")
        return None
    return plt


def plot_mel(path, mel, title=""):
    plt = _pyplot()
    if plt is None:
        return
    if mel.shape[-1] <= 256 and mel.shape[0] > mel.shape[-1]:
        mel = mel.T
    with lock:
        plt.pcolor(mel)
        if title:
            plt.title(title)
        plt.savefig(path)
        plt.close()


def plot_attn(attn, path, enc_length=None, dec_length=None):
    """Plot the best head by cumulative max-attention score
    (reference utils/infolog.py:49-72).  attn: list of [heads, dec, enc]."""
    plt = _pyplot()
    if plt is None:
        return
    results = None
    best_score = 0
    info = ""
    with lock:
        for k, layer_attn in enumerate(attn):
            if enc_length:
                layer_attn = layer_attn[:, :, :enc_length]
            if dec_length:
                layer_attn = layer_attn[:, :dec_length]
            scores = layer_attn.max(axis=-1).sum(axis=-1)   # [heads]
            head = int(np.argmax(scores))
            if scores[head] > best_score:
                results = layer_attn[head]
                best_score = scores[head]
                info = "Layer %d, Head %d" % (k, head)
        if results is None:
            return
        plt.figure(figsize=(14, 7))
        plt.pcolor(results)
        plt.title(info)
        plt.savefig(path)
        plt.close()


class ValueWindow:
    """Sliding window average (reference utils/infolog.py:74-95)."""

    def __init__(self, window_size=100):
        self._window_size = window_size
        self._values = []

    def append(self, x):
        self._values = self._values[-(self._window_size - 1):] + [x]

    @property
    def sum(self):
        return sum(self._values)

    @property
    def count(self):
        return len(self._values)

    @property
    def average(self):
        return self.sum / max(1, self.count)

    def reset(self):
        self._values = []


class LookupWindow:
    """Keyed value lists with avg/total/sum summaries
    (reference utils/infolog.py:97-127)."""

    def __init__(self, name, reduction="avg"):
        self.name = name
        self.values = defaultdict(list)
        self.reduction = reduction

    def update(self, keys, values):
        for i in range(len(keys)):
            if values[i] is None:
                continue
            self.values[keys[i]].append(values[i])

    def clear(self):
        self.values = defaultdict(list)

    def summary(self):
        results = []
        if self.reduction == "total":
            total = sum(sum(v) for v in self.values.values())
        for key in self.values:
            v = sum(self.values[key])
            if self.reduction == "sum":
                pass
            elif self.reduction == "total":
                v = v / total
            else:
                v = v / len(self.values[key])
            results.append((self.name + ("/" + key if key != "" else ""), v))
        return results


class MetricWriter:
    """Scalar writer: always appends jsonl; also writes TensorBoard events when
    the tensorboard package is available (reference uses SummaryWriter)."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a",
                           encoding="utf-8")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=logdir)
        except ImportError:   # no tensorboard: jsonl only
            pass

    def add_scalar(self, tag, value, global_step):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(global_step),
             "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=global_step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
