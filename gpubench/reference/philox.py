"""The attention kernels' dropout mask, written out from its definition.

Philox-4x32-10 (Salmon et al., SC 2011) keyed by the layer's int64 seed
(low word, high word), counter (key // 4, query, head, row), word key % 4;
a key is kept when its 32-bit word is at least rate * 2**32.  Values are
uint32 held in int64 tensors.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of m * c without overflowing int64."""
    a = c * (m & 0xFFFF)
    b = c * (m >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: torch.Tensor, row0: int, rows: int, heads: int, tq: int,
              tk: int, rate: float) -> torch.Tensor:
    """[rows, heads, tq, tk] bool, True where kept, for batch rows
    row0 .. row0 + rows - 1."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    k0, k1 = s & _MASK32, (s >> 32) & _MASK32
    ar = lambda n, at=0: torch.arange(at, at + n, dtype=torch.int64,
                                      device=dev)
    c0 = ar((tk + 3) // 4)[None, None, None, :]
    c1 = ar(tq)[None, None, :, None]
    c2 = ar(heads)[None, :, None, None]
    c3 = ar(rows, row0)[:, None, None, None]
    shape = (rows, heads, tq, c0.shape[-1])
    words = philox4x32_10(c0.expand(shape), c1.expand(shape),
                          c2.expand(shape), c3.expand(shape), k0, k1)
    bits = torch.stack(words, -1).reshape(rows, heads, tq, -1)[..., :tk]
    return bits >= int(min(rate, 1.0) * 4294967296.0)
