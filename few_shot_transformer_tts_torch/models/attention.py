"""Multi-head attention with a full-sequence path and an incremental
(KV-cache) path; counterpart of
``few_shot_transformer_tts_tpu/models/attention.py``.

Topology (reference transformer/attention.py:29-122): a fused bias-free QKV
projection for self-attention, Q plus a fused KV for cross-attention, queries
scaled by ``d_head**-0.5``, an additive bias, softmax in fp32, dropout on the
attention weights, a bias-free output projection.  ``align`` is the softmax
transposed to [B, H, memory, query].

The full-sequence path takes the CUDA kernels (``ops/mha.py``, forward and
backward through ``MhaFunction``) under the JAX package's dispatch rule:
``use_kernel`` (``hp.use_pallas_attention``), no alignments requested,
Tk <= 2048, and CUDA tensors.  Otherwise it takes the plain split-head path.
On the kernel path, active dropout runs inside the kernel at
``dropout_rate``, with a seed drawn per call from the step's generator (the
JAX package's ``make_rng("dropout")``).

Under tensor parallelism (``parallel/sharding_rules.py:shard_model_``) a
layer holds heads ``[head_offset, head_offset + local_heads)`` of
``num_heads``: the q, k and v columns of those heads and the matching rows
of ``output_transform``, over the model group ``tp_group``: the projections
are ``column_parallel`` and the output ``row_parallel``
(``models/common.py``); the kernel counts its Philox heads from
``head_offset`` and the plain path keeps its heads' slice of the whole
layer's dropout mask, so a rank drops what the whole layer would.  The
incremental path runs on whole layers only.

Score and context products upcast their (compute-dtype) operands to fp32, so
a bf16 run multiplies exactly and accumulates in fp32, as bf16 matmuls with
fp32 accumulation do.  For the same reason the KV caches and the precomputed
memory K/V hold compute-dtype values in fp32 storage.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.mha import MhaFunction, draw_seed
from .common import (column_parallel, combine_heads, dropout, row_parallel,
                     split_heads)

_KERNEL_MAX_KEYS = 2048


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype (flax Dense with
    ``dtype``): weight and bias are cast to it at use, a no-op once the
    weights were cast ahead of a decode loop."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class MultiheadAttention(nn.Module):

    def __init__(self, query_size: int, memory_size: int, key_size: int,
                 value_size: int, is_self_attention: bool, num_heads: int,
                 dropout_rate: float = 0.1, use_kernel: bool = False):
        super().__init__()
        if key_size % num_heads or value_size % num_heads:
            raise ValueError("key/value sizes must divide by the head count")
        self.key_size = key_size
        self.value_size = value_size
        self.is_self_attention = is_self_attention
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.use_kernel = use_kernel
        self.local_heads = num_heads
        self.head_offset = 0
        self.tp_group = None
        if is_self_attention:
            self.qkv_transform = Linear(query_size, key_size * 2 + value_size,
                                        bias=False)
        else:
            self.q_transform = Linear(query_size, key_size, bias=False)
            self.kv_transform = Linear(memory_size, key_size + value_size,
                                       bias=False)
        self.output_transform = Linear(value_size, key_size, bias=False)

    # ---------------- full-sequence path (teacher forcing) ------------------

    def forward(self, queries: torch.Tensor, memories: Optional[torch.Tensor],
                bias: Optional[torch.Tensor], deterministic: bool = True,
                need_align: bool = False,
                generator: Optional[torch.Generator] = None):
        """queries [B, Tq, C]; memories [B, Tm, C] or None for self-attention.

        Returns (outputs [B, Tq, C], align [B, H, Tm, Tq] or None).
        """
        heads, group = self.local_heads, self.tp_group
        ks = self.key_size // self.num_heads * heads
        vs = self.value_size // self.num_heads * heads
        if self.is_self_attention:
            q, k, v = column_parallel(self.qkv_transform, queries,
                                      group).split([ks, ks, vs], -1)
        else:
            q = column_parallel(self.q_transform, queries, group)
            k, v = column_parallel(self.kv_transform, memories,
                                   group).split([ks, vs], -1)

        depth = ks // heads
        active = not deterministic and self.dropout_rate > 0.0
        if self.use_kernel and not need_align and q.is_cuda and \
                k.shape[1] <= _KERNEL_MAX_KEYS:
            causal = bias is not None and bias.dim() == 4 and \
                bias.shape[0] == 1 and bias.shape[2] == bias.shape[3]
            use_bias = not (causal or bias is None)
            bias_vec = bias[:, 0, 0, :].float().contiguous() if use_bias \
                else None
            rate = self.dropout_rate if active else 0.0
            seed = draw_seed(generator, q.device) if rate > 0.0 else None
            x = MhaFunction.apply(q, k, v, bias_vec, seed, heads, causal,
                                  depth ** -0.5, use_bias, rate,
                                  self.head_offset)
            return row_parallel(self.output_transform, x, group), None

        dtype = q.dtype
        q = split_heads(q, heads) * (depth ** -0.5)
        k = split_heads(k, heads)
        v = split_heads(v, heads)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1)
        align = weights.transpose(2, 3) if need_align else None
        shard = None if heads == self.num_heads else \
            (1, self.head_offset, self.num_heads)
        weights = dropout(weights, self.dropout_rate, active, generator,
                          shard)
        ctx = torch.matmul(weights.to(dtype).float(), v.float())
        return row_parallel(self.output_transform,
                            combine_heads(ctx.to(dtype)), group), align

    # ---------------- incremental path (AR decode) --------------------------

    def _check_whole(self):
        if self.local_heads != self.num_heads:
            raise ValueError("the incremental attention path runs on whole "
                             "layers, not on a tensor-parallel rank's %d of "
                             "%d heads" % (self.local_heads, self.num_heads))

    def project_kv(self, memories: torch.Tensor):
        """Split-head cross-attention K/V of the encoder memory, computed once
        per utterance: (k [B, H, Tm, Dk], v [B, H, Tm, Dv]) in fp32 storage."""
        self._check_whole()
        k, v = self.kv_transform(memories).split(
            [self.key_size, self.value_size], -1)
        return (split_heads(k, self.num_heads).float(),
                split_heads(v, self.num_heads).float())

    def decode_self_step(self, x: torch.Tensor, cache_k: torch.Tensor,
                         cache_v: torch.Tensor, step: int,
                         deterministic: bool = True,
                         generator: Optional[torch.Generator] = None):
        """One causal self-attention step.

        x [B, C] (layer-normed input); cache_k/v [B, H, Tcap, D] fp32, written
        in place at ``step``.  Attends over positions 0..step only (the JAX
        package masks the rest of the capacity at -1e20, whose weights are
        exactly 0).  Returns (out [B, C], align [B, H, step+1]).
        """
        self._check_whole()
        ks, vs = self.key_size, self.value_size
        q, k, v = self.qkv_transform(x).split([ks, ks, vs], -1)
        b = x.shape[0]
        dtype = x.dtype
        depth = ks // self.num_heads
        q = (q * depth ** -0.5).reshape(b, self.num_heads, depth)
        cache_k[:, :, step] = k.reshape(b, self.num_heads, depth).float()
        cache_v[:, :, step] = v.reshape(b, self.num_heads, -1).float()
        ck = cache_k[:, :, :step + 1]
        cv = cache_v[:, :, :step + 1]
        logits = torch.matmul(ck, q.float()[..., None])[..., 0]
        weights = torch.softmax(logits, dim=-1)
        align = weights
        weights = dropout(weights, self.dropout_rate, not deterministic,
                          generator)
        ctx = torch.matmul(weights.to(dtype).float()[:, :, None], cv)[:, :, 0]
        out = self.output_transform(ctx.to(dtype).reshape(b, vs))
        return out, align

    def decode_cross_step(self, x: torch.Tensor, mem_k: torch.Tensor,
                          mem_v: torch.Tensor, mem_bias: torch.Tensor,
                          deterministic: bool = True,
                          generator: Optional[torch.Generator] = None):
        """One cross-attention step.

        x [B, C]; mem_k/v [B, H, Tm, D] fp32; mem_bias [B, 1, 1, Tm].
        Returns (out [B, C], align [B, H, Tm]).
        """
        q = self.q_transform(x)
        b = x.shape[0]
        dtype = x.dtype
        depth = self.key_size // self.num_heads
        q = (q * depth ** -0.5).reshape(b, self.num_heads, depth)
        logits = torch.matmul(mem_k, q.float()[..., None])[..., 0]
        logits = logits + mem_bias[:, 0, 0, :][:, None, :]
        weights = torch.softmax(logits, dim=-1)
        align = weights
        weights = dropout(weights, self.dropout_rate, not deterministic,
                          generator)
        ctx = torch.matmul(weights.to(dtype).float()[:, :, None],
                           mem_v)[:, :, 0]
        out = self.output_transform(ctx.to(dtype).reshape(b, self.value_size))
        return out, align

