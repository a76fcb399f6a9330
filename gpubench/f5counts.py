"""Operation counts of F5-TTS's DiT at a row's true length, for the
``flow_synth`` cell's share of the peak (``readers.mfu``).

As in ``counts.py``: the products of each row at its true length, two
operations per multiply-add; norms, softmax, modulation math, RoPE and
other elementwise work are left out, and so are the time path (one flow
time per step, shared by the rows) and the padding of a batch, so a share
of the peak made from them is conservative.  The attention kernel's bound
stays with ``counts.attention_forward_s``, applied to each call's shapes
by the traced window.
"""

from __future__ import annotations

from .reference.f5tts import (CONV_POS_GROUPS, CONV_POS_KERNEL, FF_MULT,
                              TEXT_CONV_MULT)


def attention_flops(n: int, dim: int) -> float:
    """QK^T and PV of one layer over one row of n frames, bidirectional."""
    return 4.0 * n * n * dim


def dit_pass_flops(hp, n: int) -> float:
    """One DiT pass of a row of n frames: the input projection, the two
    grouped position convs, every block's q, k, v, output and FFN
    products and its attention, and the output projection."""
    d, m = hp.dit_dim, hp.num_mels
    inp = 2.0 * n * (2 * m + hp.text_dim) * d + \
        2 * 2.0 * n * d * (d // CONV_POS_GROUPS) * CONV_POS_KERNEL
    block = 2.0 * n * 4 * d * d + 2 * 2.0 * n * d * d * FF_MULT + \
        attention_flops(n, d)
    return inp + hp.dit_depth * block + 2.0 * n * d * m


def text_flops(hp, n: int) -> float:
    """The text embedding of a row of n frames: each ConvNeXt-V2 block's
    depthwise conv (k=7) and its two pointwise products."""
    td, h = hp.text_dim, hp.text_dim * TEXT_CONV_MULT
    return hp.text_conv_layers * (2.0 * n * td * 7 + 2 * 2.0 * n * td * h)


def sample_row_flops(hp, n: int) -> float:
    """A row's synthesis: both CFG halves of every Euler step, and the text
    embedding of both halves once."""
    return 2 * hp.flow_nfe * dit_pass_flops(hp, n) + 2 * text_flops(hp, n)
