"""Reader and writer of flax's msgpack checkpoints, without the ``msgpack``
package.

``few_shot_transformer_tts_tpu/train/checkpoint.py`` writes a train state as
``flax.serialization.to_bytes``: one msgpack document of nested maps with
str keys, whose array leaves are msgpack ext types (flax
``serialization.py``):

  ext 1  ndarray   payload: a msgpack array (shape, dtype name, raw C bytes)
  ext 2  complex   payload: a msgpack array (real, imag)
  ext 3  npscalar  payload as ext 1, unpacked to a scalar

and whose leaves above ``MAX_CHUNK_SIZE`` bytes are dicts
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
flat piece, ...}}``.  ``loads`` gives what ``flax.serialization.
msgpack_restore`` gives (dicts, lists, numpy arrays and scalars), except
that a ``bfloat16`` leaf, which numpy has no dtype for, is a torch tensor.
``dumps`` writes the bytes ``to_bytes`` writes for the same tree (numpy
arrays and scalars, or torch tensors, as leaves).  Any other msgpack type
or ext code raises ``ValueError`` naming it.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30          # flax.serialization.MAX_CHUNK_SIZE

_TORCH_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                      torch.float32: "float32", torch.float64: "float64",
                      torch.int8: "int8", torch.int16: "int16",
                      torch.int32: "int32", torch.int64: "int64",
                      torch.uint8: "uint8", torch.bool: "bool"}

# fixed-size values (float32/64, uint8-64, int8-64): type byte -> format
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed values: type byte -> (length format, kind)
_LENGTHS = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
            0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
            0xdc: (">H", "array"), 0xdd: (">I", "array"),
            0xde: (">H", "map"), 0xdf: (">I", "map"),
            0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    """One msgpack document over a buffer.  With ``views``, bin values come
    back as memoryviews into it (no copy), else as bytes."""

    def __init__(self, buf: memoryview, views: bool = False):
        self.buf = buf
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends %d bytes early"
                             % (self.pos + n - len(self.buf)))
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        code = self.take(1)[0]
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0x80 <= code <= 0x8f:
            return self.map(code & 0x0f)
        if 0x90 <= code <= 0x9f:
            return [self.value() for _ in range(code & 0x0f)]
        if 0xa0 <= code <= 0xbf:
            return self.str(code & 0x1f)
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in _SCALARS:
            return self.unpack(_SCALARS[code])
        if code in _FIXEXT:
            return self.ext(_FIXEXT[code])
        if code in _LENGTHS:
            fmt, kind = _LENGTHS[code]
            n = self.unpack(fmt)
            if kind == "bin":
                raw = self.take(n)
                return raw if self.views else bytes(raw)
            if kind == "str":
                return self.str(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        raise ValueError("msgpack type byte 0x%02x is not a type flax "
                         "writes" % code)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, int, float, bool, type(None))):
                raise ValueError("msgpack map key of type %s"
                                 % type(key).__name__)
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _document(payload)
            return complex(real, imag)
        raise ValueError("msgpack ext code %d is not one of flax's (1 "
                         "ndarray, 2 complex, 3 npscalar)" % code)


def _document(buf: memoryview, views: bool = False) -> Any:
    reader = _Reader(buf, views)
    out = reader.value()
    if reader.pos != len(buf):
        raise ValueError("%d bytes follow the msgpack document"
                         % (len(buf) - reader.pos))
    return out


def _ndarray(payload: memoryview):
    """flax ``_ndarray_from_bytes``: a numpy view of the raw bytes, or for
    ``bfloat16`` a torch tensor (a copy: the bytes need not be aligned)."""
    shape, dtype, raw = _document(payload, views=True)
    if isinstance(dtype, memoryview):
        dtype = bytes(dtype).decode("ascii")
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":
        if len(raw) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(raw),
                                dtype=torch.bfloat16).reshape(shape)
    try:
        np_dtype = np.dtype(dtype)
    except TypeError:
        raise ValueError("ndarray leaf of unknown dtype %r" % dtype) from None
    return np.frombuffer(raw, dtype=np_dtype).reshape(shape)


def _unchunk(tree):
    """flax ``_unchunk_array_leaves_in_place``: chunked leaves in dicts back
    to arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """The tree of a flax msgpack document.  Array leaves are writable views
    into one copy of ``data``."""
    return _unchunk(_document(memoryview(bytearray(data))))


def load(path: str) -> Any:
    """``loads`` of a file, read into one buffer."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        if f.readinto(buf) != len(buf):
            raise ValueError("%s changed size while it was read" % path)
    return _unchunk(_document(memoryview(buf)))


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8 (where
    there is one), 16 or 32-bit form."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError("msgpack length %d too large" % n)


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARRAY = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_EXT = ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff), (0xc9, ">I", 0xffffffff))


def _pack_int(out: bytearray, v: int) -> None:
    """The shortest form, in msgpack-python's order of choice."""
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xff)
    elif 0x80 <= v <= 0xff:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0xff < v <= 0xffff:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xffff < v <= 0xffffffff:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xffffffff < v <= 0xffffffffffffffff:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise ValueError("integer %d does not fit msgpack" % v)


def _array_payload(shape, dtype: str, raw) -> bytes:
    """flax ``_ndarray_to_bytes``: (shape, dtype name, raw bytes)."""
    out = bytearray()
    _pack(out, [list(shape), dtype, raw])
    return bytes(out)


def _ext(out: bytearray, code: int, payload) -> None:
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        out.append({1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}[n])
    else:
        _header(out, n, None, 0, _EXT)
    out += struct.pack(">b", code)
    out += payload


def _tensor_raw(t: torch.Tensor):
    """(shape, dtype name, C-order bytes) of a torch tensor."""
    if t.dtype not in _TORCH_DTYPE_NAMES:
        raise ValueError("tensor leaf of dtype %s" % t.dtype)
    t = t.detach().cpu().contiguous()
    flat = t.reshape(-1)
    view = flat.view(torch.int16) if t.dtype == torch.bfloat16 else flat
    return tuple(t.shape), _TORCH_DTYPE_NAMES[t.dtype], \
        view.numpy().tobytes()


def _pack(out: bytearray, v) -> None:
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject or v.dtype.isalignedstruct:
            raise ValueError("ndarray leaf of dtype %s" % v.dtype)
        _ext(out, EXT_NDARRAY,
             _array_payload(v.shape, v.dtype.name, v.tobytes("C")))
    elif isinstance(v, np.generic):
        a = np.asarray(v)
        _ext(out, EXT_NPSCALAR,
             _array_payload(a.shape, a.dtype.name, a.tobytes("C")))
    elif isinstance(v, torch.Tensor):
        _ext(out, EXT_NDARRAY, _array_payload(*_tensor_raw(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out += b"\xcb" + struct.pack(">d", v)
    elif isinstance(v, complex):
        payload = bytearray()
        _pack(payload, [v.real, v.imag])
        _ext(out, EXT_COMPLEX, bytes(payload))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _header(out, len(raw), 0xa0, 32, _STR)
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _header(out, len(v), None, 0, _BIN)
        out += v
    elif isinstance(v, dict):
        _header(out, len(v), 0x80, 16, _MAP)
        for key, val in v.items():
            _pack(out, key)
            _pack(out, val)
    elif isinstance(v, (list, tuple)):
        _header(out, len(v), 0x90, 16, _ARRAY)
        for val in v:
            _pack(out, val)
    else:
        raise ValueError("cannot write a %s to msgpack" % type(v).__name__)


def _chunk(tree):
    """flax ``_chunk_array_leaves_in_place``: dict leaves above
    ``MAX_CHUNK_SIZE`` bytes as chunked dicts."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        itemsize = tree.itemsize if isinstance(tree, np.ndarray) \
            else tree.element_size()
        size = tree.size if isinstance(tree, np.ndarray) else tree.numel()
        if size * itemsize > MAX_CHUNK_SIZE:
            step = max(1, int(MAX_CHUNK_SIZE / itemsize))
            flat = tree.reshape(-1)
            return {CHUNKED: True,
                    "shape": {str(i): int(d)
                              for i, d in enumerate(tree.shape)},
                    "chunks": {str(i): flat[j:j + step] for i, j in
                               enumerate(range(0, size, step))}}
    return tree


def dumps(tree) -> bytes:
    """msgpack bytes of ``tree`` as ``flax.serialization.msgpack_serialize``
    writes them."""
    out = bytearray()
    _pack(out, _chunk(tree))
    return bytes(out)
