"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root, at first use, and loaded with ``ctypes``.  The hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source is rebuilt.  The compiler's output (``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as ``.log``.
``build_all`` starts one ``nvcc`` per source at once.

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


def sources() -> list:
    """The names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / (name + ".cu")).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def _start(name: str):
    """(library path, nvcc process or None when the library exists)."""
    out = library_path(name)
    if out.exists():
        return out, None
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp%d" % os.getpid())
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / (name + ".cu"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def _finish(name: str, out: Path, proc) -> Path:
    if proc is None:
        return out
    log = proc.communicate()[0]
    tmp = out.with_name(out.name + ".tmp%d" % os.getpid())
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build %s.cu:\n%s" % (name, log))
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for its hash exists."""
    return _finish(name, *_start(name))


def build_all() -> dict:
    """Build every source at once (one nvcc each); {name: library path}."""
    started = {name: _start(name) for name in sources()}
    built, errors = {}, []
    for name, job in started.items():   # wait for every nvcc, then raise
        try:
            built[name] = _finish(name, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
