"""Logging and plots for synthesis output; own copy of ``set_logger``,
``plot_mel`` and ``plot_attn`` from ``few_shot_transformer_tts_tpu/utils/
infolog.py`` (reference utils/infolog.py:16-72).

matplotlib is optional: where it is missing, the plots are skipped with one
logged warning, and the ``.npy``/``.wav`` outputs are written all the same.
"""

from __future__ import annotations

import logging
import sys
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
