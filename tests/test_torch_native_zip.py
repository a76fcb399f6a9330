"""The port's native zip reader (``native/zipreader.cpp`` built with g++ at
first use, ``native/zipreader.py``) and ``ZipStore``'s use of it: the
counterparts of the JAX package's ``tests/test_native_zip.py`` (build and
read, missing and deflated entries, the store's use of it, threaded
reads), the same bytes as the JAX ``NativeZipReader`` on one archive, the
library in the repository's build directory keyed by the source's hash
(one that does not load, built on another host, built again), a failed
build logged once, and a store without the library reading through
``zipfile``.
"""

import io
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from few_shot_transformer_tts_torch.data.zipstore import ZipStore
from few_shot_transformer_tts_torch.native import zipreader


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("nzip") / "test.zip"
    rng = np.random.RandomState(0)
    with zipfile.ZipFile(path, "w") as zf:  # default ZIP_STORED
        for i in range(20):
            buf = io.BytesIO()
            np.save(buf, rng.randn(i + 1, 8).astype(np.float32))
            zf.writestr("mel_%04d.npy" % i, buf.getvalue())
        zf.writestr("deflated.bin", b"x" * 1000,
                    compress_type=zipfile.ZIP_DEFLATED)
    return str(path)


def test_native_reader_builds_and_reads(zip_path):
    lib = zipreader.library_path()
    assert lib.parent == zipreader.BUILD_DIR
    assert lib.parent.parts[-2:] == ("build", "native")
    r = zipreader.NativeZipReader(zip_path)
    assert lib.exists()
    assert len(r) == 21
    names = r.namelist()
    assert "mel_0003.npy" in names and "deflated.bin" in names
    data = r.read("mel_0003.npy")
    assert data == zipfile.ZipFile(zip_path).read("mel_0003.npy")
    assert np.load(io.BytesIO(data)).shape == (4, 8)


def test_native_reader_missing_and_deflated(zip_path):
    r = zipreader.NativeZipReader(zip_path)
    assert r.read("nonexistent") is None
    assert r.read("deflated.bin") is None  # zipfile's territory


def test_zipstore_reads_stored_entries_natively(zip_path):
    store = ZipStore(zip_path)
    assert store._native is not None
    arr = store.read_npy("mel_0005.npy")
    assert arr.shape == (6, 8)
    assert (store.native_reads, store.zipfile_reads) == (1, 0)
    # a deflated entry goes through zipfile
    assert store.read_bytes("deflated.bin") == b"x" * 1000
    assert (store.native_reads, store.zipfile_reads) == (1, 1)
    with pytest.raises(KeyError):
        store.read_bytes("nonexistent")


def test_threaded_reads(zip_path):
    r = zipreader.NativeZipReader(zip_path)
    ref = {n: zipfile.ZipFile(zip_path).read(n)
           for n in r.namelist() if n.endswith(".npy")}

    def hit(i):
        name = "mel_%04d.npy" % (i % 20)
        return r.read(name) == ref[name]

    with ThreadPoolExecutor(8) as ex:
        assert all(ex.map(hit, range(400)))


def test_same_bytes_as_the_jax_reader(zip_path):
    from few_shot_transformer_tts_tpu.native import zipreader as jax_reader
    mine = zipreader.NativeZipReader(zip_path)
    theirs = jax_reader.NativeZipReader(zip_path)
    assert mine.namelist() == theirs.namelist()
    for name in theirs.namelist():
        assert mine.read(name) == theirs.read(name), name


def test_store_without_the_library_reads_through_zipfile(zip_path,
                                                         monkeypatch):
    monkeypatch.setattr(zipreader, "library", lambda: None)
    store = ZipStore(zip_path)
    assert store._native is None
    assert store.read_npy("mel_0002.npy").shape == (3, 8)
    assert (store.native_reads, store.zipfile_reads) == (0, 1)


def test_failed_build_is_logged_once(monkeypatch, caplog):
    monkeypatch.setattr(zipreader, "_lib", None)
    monkeypatch.setattr(zipreader.shutil, "which", lambda name: None)
    monkeypatch.setattr(zipreader, "library_path",
                        lambda: zipreader.BUILD_DIR / "libzipreader-none.so")
    with caplog.at_level("WARNING"):
        assert zipreader.library() is None
        assert zipreader.library() is None
    warnings = [r for r in caplog.records if "zip reader" in r.getMessage()]
    assert len(warnings) == 1 and "g++" in warnings[0].getMessage()


def test_a_library_that_does_not_load_is_built_again(tmp_path, monkeypatch,
                                                     zip_path):
    monkeypatch.setattr(zipreader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(zipreader, "_lib", None)
    stale = zipreader.library_path()
    stale.write_bytes(b"not a shared library")
    lib = zipreader.library()
    assert lib is not None and stale.read_bytes()[:4] == b"\x7fELF"
    assert zipreader.NativeZipReader(zip_path).read("mel_0001.npy") == \
        zipfile.ZipFile(zip_path).read("mel_0001.npy")
