"""Mel store access: zip archives of .npy files.

Own copy of ``few_shot_transformer_tts_tpu/data/zipstore.py`` that reads with
Python's ``zipfile`` only (the JAX package's native mmap reader is not
ported).  The packed dataset format is the reference's ``mels.zip``
(reference corpora/process_corpus.py:296-348: one ``<name>.npy`` per
utterance), so reference-packed data loads unchanged.  A process-wide handle
cache mirrors reference dataloader.py:16-22.
"""

from __future__ import annotations

import io
import threading
import zipfile
from typing import Dict

import numpy as np

_zip_cache: Dict[str, "ZipStore"] = {}
_cache_lock = threading.Lock()


def load_zip(filename: str) -> "ZipStore":
    with _cache_lock:
        if filename not in _zip_cache:
            _zip_cache[filename] = ZipStore(filename)
        return _zip_cache[filename]


class ZipStore:
    """Thread-safe reader of npy entries from a zip archive."""

    def __init__(self, filename: str):
        self.filename = filename
        self._zf = zipfile.ZipFile(filename)
        self._lock = threading.Lock()

    def namelist(self):
        return self._zf.namelist()

    def read_npy(self, name: str) -> np.ndarray:
        with self._lock:
            data = self._zf.read(name)
        return np.load(io.BytesIO(data))

    # reference-compatible alias (dataloader.py:413-416)
    def load(self, npy_name: str) -> np.ndarray:
        return self.read_npy(npy_name)
