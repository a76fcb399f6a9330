"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root, at first use, and loaded with ``ctypes``.  The hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source is rebuilt.  The compiler's output (``-Xptxas -v``: registers,
shared memory, spills) is kept beside the library as ``.log``.

The attention sources (``HEAD_DIM_SOURCES``) are built once per head dim,
``-DHEAD_DIM=<D>``, into ``lib<name>-d<D>-<hash>.so`` (the define is in the
hash), for every head dim of ``HEAD_DIMS``: one instantiation per library
keeps each build short, and a run builds only the head dims it meets.
``build_all`` starts one ``nvcc`` per (source, head dim) at once.

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
# sources built once per head dim (csrc/mha_fwd.cu, csrc/mha_bwd.cu), and
# the head dims they are built for: every multiple of 32 up to 256
HEAD_DIM_SOURCES = ("mha_bwd", "mha_fwd")
HEAD_DIMS = tuple(range(32, 257, 32))

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


def _flags(head_dim) -> tuple:
    return NVCC_FLAGS if head_dim is None else \
        NVCC_FLAGS + ("-DHEAD_DIM=%d" % head_dim,)


def _check_head_dim(name: str, head_dim) -> None:
    if (name in HEAD_DIM_SOURCES) != (head_dim is not None):
        raise ValueError("%s.cu is built %s" % (
            name, "once per head dim: give head_dim"
            if head_dim is None else "without a head dim"))


def library_path(name: str, head_dim=None) -> Path:
    h = hashlib.sha256((CSRC_DIR / (name + ".cu")).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(head_dim)).encode())
    tag = name if head_dim is None else "%s-d%d" % (name, head_dim)
    return BUILD_DIR / ("lib%s-%s.so" % (tag, h.hexdigest()[:16]))


def _start(name: str, head_dim=None):
    """(library path, nvcc process or None when the library exists)."""
    out = library_path(name, head_dim)
    if out.exists():
        return out, None
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp%d" % os.getpid())
    proc = subprocess.Popen(
        [nvcc, *_flags(head_dim), "-o", str(tmp),
         str(CSRC_DIR / (name + ".cu"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def _finish(out: Path, proc) -> Path:
    if proc is None:
        return out
    log = proc.communicate()[0]
    tmp = out.with_name(out.name + ".tmp%d" % os.getpid())
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed to build %s:\n%s" % (out.name, log))
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def build(name: str, head_dim=None) -> Path:
    """Compile ``csrc/<name>.cu`` (for ``head_dim``, where the source is
    built per head dim) unless the library for its hash exists."""
    return _finish(*_start(name, head_dim))


def build_all() -> dict:
    """Build every source at once (one nvcc each, the attention sources
    once per head dim of ``HEAD_DIMS``); {name or (name, head dim):
    library path}."""
    jobs = [(name, d) for name in sources()
            for d in (HEAD_DIMS if name in HEAD_DIM_SOURCES else (None,))]
    started = {job: _start(*job) for job in jobs}
    built, errors = {}, []
    for (name, d), job in started.items():   # wait for every nvcc, then raise
        try:
            built[name if d is None else (name, d)] = _finish(*job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return built


def load(name: str, head_dim=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (for ``head_dim``, where the
    source is built per head dim), built on first use."""
    _check_head_dim(name, head_dim)
    key = (name, head_dim)
    with _lock:
        if key not in _loaded:
            _loaded[key] = ctypes.CDLL(str(build(name, head_dim)))
        return _loaded[key]
