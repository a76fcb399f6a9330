"""The PyTorch port stands alone: no module of it, and not chip_smoke.py,
imports JAX, flax, optax or the JAX package, nor msgpack or requests (the
port carries its own code for both jobs); and building any of its CUDA
kernels fails loudly where there is no nvcc."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "few_shot_transformer_tts_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "few_shot_transformer_tts_tpu",
             "msgpack", "requests")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        "few_shot_transformer_tts_torch." +
        ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        "for m in %r: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "print(len(%r))\n" % (modules, FORBIDDEN, modules))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) == len(modules) >= 15


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    from few_shot_transformer_tts_torch.ops import cuda_build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    sources = cuda_build.sources()
    assert sources == sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert {"mha_fwd", "mha_bwd", "mha_wide", "layernorm_bwd",
            "decoder_step", "frame_mel", "fused_adam"} <= set(sources)
    for name in sources:
        # the attention sources build once per head dim
        d = 64 if name in cuda_build.HEAD_DIM_SOURCES else None
        with pytest.raises(RuntimeError, match="nvcc was not found"):
            cuda_build.load(name, d)
        # the library name follows the source hash, so an edited source
        # rebuilds
        lib = cuda_build.library_path(name, d).name
        assert lib.startswith("lib%s-" % name) and lib.endswith(".so")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        cuda_build.build_all()
    assert not (tmp_path / "build").exists()


def test_library_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    from few_shot_transformer_tts_torch.ops import cuda_build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = cuda_build.library_path("k")
    (csrc / "h.cuh").write_text("// two\n")
    assert cuda_build.library_path("k") != before
