"""ctypes binding of the native zip reader (``zipreader.cpp``); counterpart of
``few_shot_transformer_tts_tpu/native/zipreader.py``.

The reader parses the archive's central directory once and serves stored
(uncompressed) entries with positioned ``pread`` calls: no seek state, no
lock, and no GIL while it reads (ctypes releases it for the call), so the
Feeder's threads read in parallel.  ``zipreader.cpp`` is compiled at first use
with ``g++ -O2 -shared -fPIC -std=c++17`` into ``build/native/`` at the
repository root, as ``libzipreader-<hash>.so`` keyed by a hash of the
source, and loaded with ``ctypes``.  Without a compiler (or when the build
fails) ``library()`` returns None and logs why once; ``ZipStore`` then reads
through ``zipfile``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().with_name("zipreader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source lives (built or not)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / ("libzipreader-%s.so" % h.hexdigest()[:16])


def build() -> Path:
    """Compile ``zipreader.cpp`` unless its library exists; the path.  The
    compiler writes a file of its own and renames it into place, so
    processes that build at once do not see a half-written library.
    Raises RuntimeError without ``g++`` or when it fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ was not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.%d" % (out.name, os.getpid(),
                                      threading.get_ident()))
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed on %s:\n%s" % (SOURCE,
                                                     proc.stderr[-2000:]))
    os.replace(tmp, out)
    return out


def library() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None when it cannot be
    built (the reason is logged once, at that call)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = build()
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:     # built on another host: build it here
                    path.unlink(missing_ok=True)
                    lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                logging.warning("The native zip reader is unavailable, the "
                                "mel store reads through zipfile: %s", e)
                _lib = False
                return None
            p, c, n = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long
            for fn, args, res in (("zr_open", [c], p), ("zr_close", [p], None),
                                  ("zr_size", [p, c], n),
                                  ("zr_read", [p, c, c, n], n),
                                  ("zr_count", [p], n),
                                  ("zr_names", [p, c, n], n)):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _lib = lib
        return _lib or None


class NativeZipReader:
    """Reads of stored zip entries by positioned ``pread``, safe from any
    number of threads without a lock."""

    def __init__(self, path: str):
        lib = library()
        if lib is None:
            raise RuntimeError("the native zip reader is unavailable")
        self._lib = lib
        self._handle = lib.zr_open(os.fsencode(path))
        if not self._handle:
            raise RuntimeError("failed to open zip: %s" % path)

    def read(self, name: str) -> Optional[bytes]:
        """The entry's bytes, or None when it is missing or not stored
        (deflated): those go through ``zipfile``."""
        key = name.encode()
        size = self._lib.zr_size(self._handle, key)
        if size < 0:
            return None
        buf = ctypes.create_string_buffer(size)
        if self._lib.zr_read(self._handle, key, buf, size) != size:
            return None
        return buf.raw

    def namelist(self):
        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.zr_names(self._handle, buf, cap)
            if n == -4:
                cap *= 4
                continue
            return buf.raw[:n].decode().splitlines() if n > 0 else []

    def __len__(self):
        return int(self._lib.zr_count(self._handle))

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.zr_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
