"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root, at first use, and loaded with ``ctypes``.  The hash
covers the source and the flags, so an edited source is rebuilt.  The
compiler's output (``-Xptxas -v``: registers, shared memory, spills) is kept
beside the library as ``.log``.

There is no fallback: without ``nvcc`` the build raises, and a CUDA tensor
handed to a kernel wrapper then raises with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin/nvcc`` (default
    /usr/local/cuda); raises RuntimeError when neither exists."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate) and os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(
        "nvcc was not found on PATH or under CUDA_HOME (%s): the port's CUDA "
        "kernels cannot be built, and CUDA tensors have no other path" % home)


def library_path(name: str) -> Path:
    src = CSRC_DIR / (name + ".cu")
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest))


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp%d" % os.getpid())
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / (name + ".cu"))],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build %s.cu:\n%s"
                           % (name, proc.stdout + proc.stderr))
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
