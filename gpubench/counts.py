"""The yardstick's operation and byte counts, and the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989
TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s
of HBM.  A kernel's bound is the larger of its operations over the peak
rate of its input type and its bytes over the HBM rate, with every input
read once and every output written once.

Model FLOPs count the products of each row at its true lengths (a causal
attention at half its square), two operations per multiply-add; norms,
softmax and elementwise work are left out, so a share of the peak made
from them is conservative.  A training step is three times its forward.
"""

from __future__ import annotations

PEAK_FLOPS = {2: 989e12, 4: 67e12}      # by bytes per element of the input
HBM_BYTES_PER_S = 3.35e12


def _bound(nbytes: float, flops: float, elt: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[elt])


def attention_forward_s(b, tq, tk, c, heads, causal, use_bias, elt) -> float:
    """q, k, v read and o written once, the softmax statistics written,
    the bias read; QK^T and PV over the pairs the mask keeps."""
    nbytes = (2 * b * tq * c + 2 * b * tk * c) * elt + b * tq * heads * 4 + \
        (b * tk * 4 if use_bias else 0)
    pairs = b * tq * (tq + 1) / 2 if causal else b * tq * tk
    return _bound(nbytes, 4.0 * pairs * c, elt)


def attention_backward_s(b, tq, tk, c, heads, causal, use_bias,
                         elt) -> float:
    """q, k, v, o, do read and dq, dk, dv written once, the statistics and
    bias read; five products over the pairs the mask keeps."""
    nbytes = (4 * b * tq * c + 4 * b * tk * c) * elt + b * tq * heads * 4 + \
        (b * tk * 4 if use_bias else 0)
    pairs = b * tq * (tq + 1) / 2 if causal else b * tq * tk
    return _bound(nbytes, 10.0 * pairs * c, elt)


def layernorm_backward_s(n, c, elt) -> float:
    """x, dy read and dx written once, gamma read and its two gradients
    written; about 16 float32 operations an element."""
    nbytes = 3 * n * c * elt + 3 * c * 4
    return max(nbytes / HBM_BYTES_PER_S, 16.0 * n * c / PEAK_FLOPS[4])


def decode_step_s(weight_elems, ln_elems, layers, b, t_mem, c, heads, step,
                  elt) -> float:
    """One frame through every decoder layer: the weights, the memory K/V
    and bias, the valid cache prefix and the frame's input read once; the
    output, the cross-attention weights and the new K/V written once."""
    nbytes = weight_elems * elt + ln_elems * 4 + \
        2 * layers * b * t_mem * c * elt + b * t_mem * 4 + \
        2 * layers * b * step * c * elt + 2 * b * c * 4 + \
        layers * b * t_mem * heads * 4 + 2 * layers * b * c * elt
    flops = 2.0 * b * weight_elems + \
        4.0 * layers * b * c * (step + 1 + t_mem)
    return _bound(nbytes, flops, elt)


def _encoder_forward(hp, t_in) -> float:
    he = hp.encoder_hidden
    return hp.n_encoder_layer * (24.0 * t_in * he * he +
                                 4.0 * t_in * t_in * he)


def _mem_width(hp) -> int:
    return hp.encoder_hidden + \
        (hp.speaker_embedding_size if hp.multi_speaker else 0) + \
        (hp.language_embedding_size if hp.multi_lingual else 0)


def _postnet(hp, t) -> float:
    n, ph, m = hp.n_postnet_layer, hp.postnet_hidden, hp.num_mels
    ch = [m] + [ph] * (n - 1) + [m]
    return sum(2.0 * t * 5 * ch[i] * ch[i + 1] for i in range(n))


def _frame_fixed(hp) -> float:
    """Prenet and heads of one frame."""
    p, hd, m = hp.prenet_hidden, hp.decoder_hidden, hp.num_mels
    return 2.0 * (m * p + p * p + p * hd) + 2.0 * hd * (m + 1)


def train_row_flops(hp, t_in: int, t_out: int) -> float:
    """Forward and backward of one row with these true lengths."""
    hd, dm = hp.decoder_hidden, _mem_width(hp)
    dec = hp.n_decoder_layer * (
        28.0 * t_out * hd * hd             # self qkv + out, cross q + out, FFN
        + 4.0 * (t_out * (t_out + 1) / 2) * hd      # causal self-attention
        + 4.0 * t_in * dm * hd             # cross K/V of the memory
        + 4.0 * t_out * t_in * hd)         # cross-attention
    fwd = _encoder_forward(hp, t_in) + dec + t_out * _frame_fixed(hp) + \
        _postnet(hp, t_out)
    return 3.0 * fwd


def decode_row_flops(hp, t_in: int, frames: int) -> float:
    """Synthesis of one row: the encoder, the memory's K/V, ``frames``
    decoder steps over a growing cache, the postnet."""
    hd, dm = hp.decoder_hidden, _mem_width(hp)
    layers = hp.n_decoder_layer
    per_frame = layers * (28.0 * hd * hd + 4.0 * t_in * hd) + \
        _frame_fixed(hp)
    self_attn = layers * 4.0 * hd * frames * (frames + 1) / 2
    return _encoder_forward(hp, t_in) + layers * 4.0 * t_in * dm * hd + \
        frames * per_frame + self_attn + _postnet(hp, frames)
