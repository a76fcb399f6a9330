"""Transformer primitives shared by encoder and decoder (counterpart of
``few_shot_transformer_tts_tpu/models/common.py``, reference
transformer/common.py:4-70).

The PE uses the [sin | cos] concatenated layout (not interleaved) with
min/max timescale 1/1e4 and a log increment over ``channels//2 - 1`` steps;
attention biases are additive with -1e20; ``impute`` zeroes time steps at or
beyond each sequence length.  Dropout draws its mask from an explicit
``torch.Generator`` so a decode is reproducible under one seed.

Tensor parallelism (``parallel/sharding_rules.py``) runs the Megatron pair
over a model group: ``column_parallel`` (the same input on every rank, the
input's gradient summed over the group) and ``row_parallel`` (the product
summed over the group).  Each rank's partial product, and each partial
input gradient, is kept in fp32 and rounded to the compute type once,
after the sum, as the whole layer's product is rounded once: a bf16 step
then differs from one device's by the order of fp32 sums only.  On a card
the partials are bf16 products on the tensor cores with an fp32 result
(``torch.mm``'s ``out_dtype``), which holds the exact products of the
bf16 inputs as an fp32 product of them would.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F

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
            generator: Optional[torch.Generator],
            shard: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator`` (flax
    nn.Dropout semantics: keep with probability 1-rate, scale by 1/keep).

    ``shard`` = (dim, start, full): ``x`` is the slice ``[start, start +
    x.shape[dim])`` along ``dim`` of a tensor ``full`` long there (a
    tensor-parallel rank's heads or hidden columns).  The mask of the whole
    tensor is drawn and sliced, so the rank keeps the mask the whole layer
    would draw, and the generator advances as it would."""
    if not active or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if shard is not None:
        shape[shard[0]] = shard[2]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask.narrow(shard[0], shard[1], x.shape[shard[0]])
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class _SumOverGroup(torch.autograd.Function):
    """The sum of fp32 ``x`` over the group forward; the gradient passes
    unchanged backward."""

    @staticmethod
    def forward(ctx, x, group):
        total = x.reshape(-1).clone()
        dist.all_reduce(total, group=group)
        return total.reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with an fp32 result: on a card a half-precision
    product on the tensor cores with fp32 output, else an fp32 product."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


class _ColumnParallel(torch.autograd.Function):
    """``x @ weight^T`` in x's type over this rank's output columns; the
    gradient of x is this rank's fp32 partial, summed over the group, then
    rounded once to x's type."""

    @staticmethod
    def forward(ctx, x, weight, group):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.group = group
        return F.linear(x, w)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        dx = _mm_fp32(_rows(grad), w)
        dist.all_reduce(dx, group=ctx.group)
        dw = torch.mm(_rows(grad).t(), _rows(x))
        return dx.reshape(x.shape).to(x.dtype), dw.float(), None


class _PartialProduct(torch.autograd.Function):
    """``x @ weight^T`` as an fp32 partial of x's type's inputs; backward
    in x's type, as the whole layer's product would run it."""

    @staticmethod
    def forward(ctx, x, weight):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        out = _mm_fp32(_rows(x), w.t())
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = _rows(grad).to(x.dtype)
        dx = torch.mm(grad, w).reshape(x.shape)
        dw = torch.mm(grad.t(), _rows(x))
        return dx, dw.float()


def model_parallel_sum(x: torch.Tensor, group) -> torch.Tensor:
    """fp32 ``x`` summed over ``group`` (the gradient passes unchanged), or
    ``x`` without a group of more than one rank."""
    return _SumOverGroup.apply(x, group) if spans_ranks(group) else x


def column_parallel(linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear(x)`` (bias-free) of a layer whose weight holds this rank's
    output columns; the ranks of ``group`` hold the same ``x``, and each
    contributes its part of x's gradient."""
    if not spans_ranks(group):
        return linear(x)
    return _ColumnParallel.apply(x, linear.weight, group)


def row_parallel(linear, x: torch.Tensor, group) -> torch.Tensor:
    """``linear(x)`` (bias-free) of a layer whose weight holds the rows of
    this rank's input columns ``x``: the product summed over ``group``."""
    if not spans_ranks(group):
        return linear(x)
    partial = _PartialProduct.apply(x, linear.weight)
    return model_parallel_sum(partial, group).to(x.dtype)
