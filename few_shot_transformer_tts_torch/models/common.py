"""Transformer primitives shared by encoder and decoder (counterpart of
``few_shot_transformer_tts_tpu/models/common.py``, reference
transformer/common.py:4-70).

The PE uses the [sin | cos] concatenated layout (not interleaved) with
min/max timescale 1/1e4 and a log increment over ``channels//2 - 1`` steps;
attention biases are additive with -1e20; ``impute`` zeroes time steps at or
beyond each sequence length.  Dropout draws its mask from an explicit
``torch.Generator`` so a decode is reproducible under one seed.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

NEG_INF = -1e20


@functools.lru_cache(maxsize=64)
def _sinusoid_table_np(length: int, channels: int,
                       min_timescale: float = 1.0,
                       max_timescale: float = 1e4) -> np.ndarray:
    position = np.arange(length)
    num_timescales = channels // 2
    log_timescale_increment = (
        np.log(float(max_timescale) / float(min_timescale)) / (num_timescales - 1))
    inv_timescales = min_timescale * np.exp(
        np.arange(num_timescales) * -log_timescale_increment)
    scaled_time = position[:, None] * inv_timescales[None, :]
    signal = np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1)
    signal = np.pad(signal, [[0, 0], [0, channels % 2]])
    signal = signal.astype(np.float32)
    signal.setflags(write=False)
    return signal


def sinusoid_position_encoding(length: int, channels: int,
                               device=None) -> torch.Tensor:
    """[length, channels] fp32 sinusoidal PE."""
    return torch.from_numpy(
        _sinusoid_table_np(length, channels).copy()).to(device)


def causal_bias(length: int, device=None) -> torch.Tensor:
    """[1, 1, T, T] additive causal bias."""
    mask = torch.ones(length, length, device=device).triu(1) * NEG_INF
    return mask[None, None]


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool validity mask -> [B, 1, 1, T] additive fp32 bias."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


def length_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] -> [B, max_length] boolean validity mask."""
    return torch.arange(max_length, device=lengths.device)[None, :] < \
        lengths[:, None]


def impute(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero elements with time index >= length; time is axis 1."""
    mask = length_mask(lengths, x.shape[1])
    mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
    return x * mask.to(x.dtype)


def spans_ranks(group) -> bool:
    """True when ``group`` is a process group of more than one rank."""
    return group is not None and dist.get_world_size(group) > 1


def mask_reduce(loss: torch.Tensor, lengths: torch.Tensor,
                per_sample: bool = False, group=None) -> torch.Tensor:
    """Length-masked mean of a [B, T] loss (reference transformer/common.py:
    73-87); per sample, rows of length 0 (lattice padding) divide by 1.

    With a ``group`` of more than one rank the denominator is the frame
    count of every rank's rows (an all-reduce of the integer count, outside
    autograd), so the masked sums of the ranks add up to the mean over the
    global batch, as the JAX step's mean over its sharded batch axis."""
    masked = impute(loss, lengths)
    if per_sample:
        return masked.sum(-1) / torch.clamp(lengths, min=1)
    count = lengths.sum()
    if spans_ranks(group):
        dist.all_reduce(count, group=group)
    return masked.sum() / count


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, C] -> [B, H, T, C/H]."""
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def combine_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] -> [B, T, H*D]."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def dropout(x: torch.Tensor, rate: float, active: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (flax
    nn.Dropout semantics: keep with probability 1-rate, scale by 1/keep)."""
    if not active or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
