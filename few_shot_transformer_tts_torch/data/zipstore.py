"""Mel store access: zip archives of .npy files.

Own copy of ``few_shot_transformer_tts_tpu/data/zipstore.py``.  The packed
dataset format is the reference's ``mels.zip`` (reference
corpora/process_corpus.py:296-348: ZIP_STORED entries, one ``<name>.npy``
per utterance), so reference-packed data loads unchanged.  Stored entries
are read through the native reader (``native/zipreader.py``: positioned
``pread``, no lock, no GIL while it reads); deflated and missing entries,
and every entry on a host where the reader cannot be built (logged once),
through Python's ``zipfile`` under one lock.  A process-wide handle cache
mirrors reference dataloader.py:16-22.
"""

from __future__ import annotations

import io
import threading
import zipfile
from typing import Dict

import numpy as np

from ..native import zipreader

_zip_cache: Dict[str, "ZipStore"] = {}
_cache_lock = threading.Lock()


def load_zip(filename: str) -> "ZipStore":
    with _cache_lock:
        if filename not in _zip_cache:
            _zip_cache[filename] = ZipStore(filename)
        return _zip_cache[filename]


class ZipStore:
    """Thread-safe reader of npy entries from a zip archive.

    ``native_reads`` counts the reads the native reader served (updated
    without a lock, so a check of it is a lower bound under contention);
    ``zipfile_reads`` those that went through ``zipfile`` (exact)."""

    def __init__(self, filename: str):
        self.filename = filename
        self._zf = zipfile.ZipFile(filename)
        self._lock = threading.Lock()
        self._native = None
        if zipreader.library() is not None:
            self._native = zipreader.NativeZipReader(filename)
        self.native_reads = 0
        self.zipfile_reads = 0

    def namelist(self):
        return self._zf.namelist()

    def read_bytes(self, name: str) -> bytes:
        if self._native is not None:
            buf = self._native.read(name)
            if buf is not None:
                self.native_reads += 1
                return buf
        with self._lock:
            self.zipfile_reads += 1
            return self._zf.read(name)

    def read_npy(self, name: str) -> np.ndarray:
        return np.load(io.BytesIO(self.read_bytes(name)))

    # reference-compatible alias (dataloader.py:413-416)
    def load(self, npy_name: str) -> np.ndarray:
        return self.read_npy(npy_name)
