"""Objective metrics: DTW-aligned mel MSE and character error rate; own
copy of ``few_shot_transformer_tts_tpu/utils/metrics.py``.

DTW-MSE follows reference utils/infolog.py:129-148: drop unvoiced frames
(max <= 0, valid because mels are symmetric around 0), align pred/target with
DTW under euclidean distance, mean squared difference along the path,
per-sample.  The reference uses the fastdtw package; here a full O(T^2)
dynamic-programming DTW is used (eval-only path; exact rather than
approximate).

CER follows reference utils/transcribe.py:16-63: Azure STT REST client gated on
azure_key.json, text normalization (strip punctuation categories, lowercase,
NFD, strip spaces for CJK), Levenshtein distance / len(pred) capped at 1.0.
editdistance is replaced with a numpy Levenshtein.  The Azure request goes
through ``urllib.request`` (the JAX package uses ``requests``): same
endpoint, headers, status check and JSON.  DTW stays on the host: it is the
eval service's scoring, exact, and small beside synthesis.
"""

from __future__ import annotations

import json
import logging
import os
import re
import traceback
import unicodedata
import urllib.error
import urllib.request
from typing import List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# DTW mel distortion
# ---------------------------------------------------------------------------


def dtw_path(x: np.ndarray, y: np.ndarray):
    """Exact DTW alignment path between sequences x [Tx, D], y [Ty, D]
    under euclidean distance.  Returns (distance, path list of (i, j))."""
    tx, ty = len(x), len(y)
    # pairwise euclidean distances, vectorized
    d = np.sqrt(np.maximum(
        (np.square(x).sum(-1)[:, None] + np.square(y).sum(-1)[None, :]
         - 2.0 * x @ y.T), 0.0))
    cost = np.full((tx + 1, ty + 1), np.inf)
    cost[0, 0] = 0.0
    for i in range(1, tx + 1):
        row = cost[i - 1]
        prev = cost[i]
        prev[1:] = d[i - 1]
        # cost[i, j] = d + min(cost[i-1, j], cost[i, j-1], cost[i-1, j-1])
        run = np.inf
        di = d[i - 1]
        for j in range(1, ty + 1):
            best = min(row[j], row[j - 1], run)
            run = di[j - 1] + best
            prev[j] = run
    # backtrack
    path = []
    i, j = tx, ty
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = [(cost[i - 1, j - 1], i - 1, j - 1),
                 (cost[i - 1, j], i - 1, j),
                 (cost[i, j - 1], i, j - 1)]
        _, i, j = min(moves, key=lambda t: t[0])
    path.reverse()
    return float(cost[tx, ty]), path


def calculate_mse_dtw(preds, pred_lengths, targets, target_lengths) -> List[Optional[float]]:
    """Per-sample DTW-MSE (reference utils/infolog.py:129-148)."""
    results = []
    preds = np.asarray(preds)
    targets = np.asarray(targets)
    for i in range(len(preds)):
        x = preds[i, :pred_lengths[i]]
        y = targets[i, :target_lengths[i]]
        x = x[np.max(x, axis=-1) > 0]
        y = y[np.max(y, axis=-1) > 0]
        if len(x) == 0 or len(y) == 0:
            results.append(None)
            continue
        _, path = dtw_path(x, y)
        px = np.asarray([p[0] for p in path])
        py = np.asarray([p[1] for p in path])
        results.append(float(np.square(x[px] - y[py]).mean()))
    return results


# ---------------------------------------------------------------------------
# CER / transcription
# ---------------------------------------------------------------------------


def levenshtein(a: str, b: str) -> int:
    """Edit distance (replaces the editdistance package)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i, ca in enumerate(a, 1):
        cur = np.empty(len(b) + 1, dtype=np.int64)
        cur[0] = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return int(prev[-1])


_CJK_LOCALES = ["zh", "zh-cn", "th-th", "zh-tw", "zh-hk", "ja-jp", "ko-kr"]


def basic_normalize(text: str, locale: str) -> str:
    """reference utils/transcribe.py:16-26."""
    text_ = ""
    for ch in text:
        if unicodedata.category(ch) in ["Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po"]:
            continue
        if locale in _CJK_LOCALES and ch == " ":
            continue
        text_ += ch.lower()
    text_ = re.sub(r"\s+", " ", text_)
    text_ = unicodedata.normalize("NFD", text_)
    return text_.strip()


def character_error_rate(truth: str, pred: str, locale: str = "") -> float:
    truth = basic_normalize(truth, locale)
    pred = basic_normalize(pred, locale)
    return min(1.0, levenshtein(truth, pred) / (len(pred) + 1e-9))


def _load_azure_config():
    if os.path.exists("azure_key.json"):
        with open("azure_key.json") as f:
            return json.load(f)
    return None


def transcribe_available() -> bool:
    return _load_azure_config() is not None


def azure_transcribe(audio_path: str, lang: str):
    """reference utils/transcribe.py:29-40; None unless the service answers
    200."""
    config = _load_azure_config()
    if lang == "zh":
        lang = "zh-cn"
    endpoint = (
        "https://%s.stt.speech.microsoft.com/speech/recognition/conversation/"
        "cognitiveservices/v1?format=detailed&profanity=raw&language=%s"
        % (config["region"], lang))
    header = {"Ocp-Apim-Subscription-Key": config["subscription"],
              "Content-Type": "audio/wav"}
    with open(audio_path, "rb") as f:
        data = f.read()
    request = urllib.request.Request(endpoint, data=data, headers=header,
                                     method="POST")
    try:
        with urllib.request.urlopen(request) as response:
            status, content = response.status, response.read()
    except urllib.error.HTTPError:   # urllib raises where requests returns
        return None
    if status != 200:
        return None
    return json.loads(content)


def transcribe(wav_path: str, meta: dict, id_to_lang) -> dict:
    """Transcribe + CER with 5 retries (reference utils/transcribe.py:43-63)."""
    lang = id_to_lang(meta["i"])
    for _ in range(5):
        try:
            assert os.path.exists(wav_path), wav_path + " not exists"
            result = azure_transcribe(wav_path, lang)
            if result is None or result["RecognitionStatus"] != "Success":
                raise ValueError("Fail to transcribe " + str(result))
            result["locale"] = lang
            result["name"] = meta["n"][:-4]
            result["truth"] = truth = basic_normalize(meta["t"], lang)
            result["pred"] = pred = basic_normalize(
                result["NBest"][0]["Lexical"], lang)
            cer = min(1.0, levenshtein(truth, pred) / (len(pred) + 1e-9))
            logging.info('%s %.3f: "%s" | "%s"', result["name"], cer,
                         truth.encode("unicode-escape"),
                         pred.encode("unicode-escape"))
            result["cer"] = cer
            return result
        except Exception:
            logging.error("Fail to transcribe %s, retry... (%s)", wav_path, meta)
            logging.error(traceback.format_exc())
    return {"cer": 1.0, "locale": lang, "name": meta["n"][:-4],
            "DisplayText": "", "fail": True}
