"""Tensor parallelism over the ``model`` axis of the ``(data, model)`` grid;
counterpart of ``few_shot_transformer_tts_tpu/parallel/sharding_rules.py``
(``param_pspec``, ``state_shardings(..., tensor_parallel=True)``).

The same Megatron-style rule, by the same owner names:

  attention qkv/q/kv projections   kernel [in, out]  -> shard out (heads)
  attention output projection      kernel [in, out]  -> shard in
  FFN input_layer                  kernel [in, 4H]   -> shard out
  FFN output_layer                 kernel [4H, out]  -> shard in

Everything else (embeddings, norms, prenet, postnet with its BatchNorm,
heads) stays replicated on the model group; Adam's moments follow their
parameters.  JAX lets XLA split each leaf and insert the collectives; the
port splits each pair by hand (``shard_model_``): model rank ``m`` of ``M``
keeps the q, k and v columns of heads ``[m H/M, (m+1) H/M)`` and the
matching rows of ``output_transform``, and the FFN's hidden columns
``[m 4H/M, (m+1) 4H/M)`` and the matching rows of ``output_layer``; the
layers run those products through ``models/common.py``'s
``column_parallel`` and ``row_parallel``, which add the all-reduces.  A
pair is split only when its heads (for the FFN its hidden width) divide by
``M``; otherwise both halves stay whole on every rank, with the same math,
and ``shard_model_`` logs which.  JAX instead falls back per leaf, which
XLA can do and a hand-split pair cannot.

Each split parameter carries its ``ShardSpec`` as ``param.tp``: the dim of
the torch weight that is split and the ranges of the whole leaf this rank
holds, in order.  Under the fused ``[q|k|v]`` layout those are three ranges
(its heads' columns of each of q, k and v), not the contiguous slice JAX's
column sharding takes; the checkpoint writer records them as such slices
of the JAX layout, which every loader of the sharded format accepts.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

COL_PARALLEL = ("qkv_transform", "q_transform", "kv_transform",
                "input_layer")       # shard kernel dim 1 (output)
ROW_PARALLEL = ("output_transform", "output_layer")  # shard kernel dim 0
# equal parts along the output dim of the fused projections: [q|k|v], [k|v]
_PARTS = {"qkv_transform": 3, "kv_transform": 2}


def split_dim(path_keys: Sequence[str]) -> Optional[int]:
    """The dim of a leaf in the JAX layout that the model axis splits
    (where ``param_pspec`` puts "model"): 1 for a column-parallel kernel, 0
    for a row-parallel one, None for a replicated leaf.  ``path_keys``: the
    leaf's flax path (``opt_state`` moments end in the same keys)."""
    if len(path_keys) >= 2 and path_keys[-1] == "kernel":
        owner = path_keys[-2]
        if owner in COL_PARALLEL:
            return 1
        if owner in ROW_PARALLEL:
            return 0
    return None


@dataclass(frozen=True)
class ShardSpec:
    """What a model rank holds of one split weight (torch layout)."""
    dim: int                       # the dim of the torch weight split
    ranges: Tuple[slice, ...]      # of the whole weight along dim, in order
    full_shape: Tuple[int, ...]    # the whole weight
    group: Any                     # the model group


def owned_ranges(size: int, parts: int, rank: int,
                 model: int) -> Tuple[slice, ...]:
    """The ranges of a dim of ``size`` (``parts`` equal parts side by side,
    as ``[q|k|v]``) that model rank ``rank`` of ``model`` holds: its
    ``1/model`` of each part."""
    part = size // parts
    width = part // model
    return tuple(slice(j * part + rank * width, j * part + (rank + 1) * width)
                 for j in range(parts))


def take(full: torch.Tensor, spec: ShardSpec) -> torch.Tensor:
    """This rank's local tensor of a whole leaf (torch layout)."""
    return torch.cat([full.narrow(spec.dim, r.start, r.stop - r.start)
                      for r in spec.ranges], spec.dim).contiguous()


def pieces(local: torch.Tensor, spec: ShardSpec
           ) -> List[Tuple[Tuple[slice, ...], torch.Tensor]]:
    """(index of the whole leaf, piece) for each range a local tensor holds,
    in the torch layout."""
    out, at = [], 0
    for r in spec.ranges:
        width = r.stop - r.start
        index = [slice(None)] * len(spec.full_shape)
        index[spec.dim] = slice(r.start, r.stop)
        out.append((tuple(index), local.narrow(spec.dim, at, width)))
        at += width
    return out


def _split_linear(linear: nn.Linear, owner: str, rank: int, model: int,
                  group) -> None:
    """Replace ``linear.weight`` by this rank's part (a new parameter)."""
    w = linear.weight
    dim = 0 if owner in COL_PARALLEL else 1      # torch weight is [out, in]
    spec = ShardSpec(dim, owned_ranges(w.shape[dim], _PARTS.get(owner, 1),
                                       rank, model),
                     tuple(w.shape), group)
    linear.weight = nn.Parameter(take(w.detach(), spec))
    linear.weight.tp = spec


def shard_model_(model: nn.Module, rank: int, model_size: int,
                 group) -> List[str]:
    """Split ``model``'s attention and FFN pairs over the model group, in
    place, as rank ``rank`` of ``model_size``: its parameters of those pairs
    become new, smaller ones (build the optimizer after this).  Returns the
    names of the layers that stay whole because their heads (or hidden
    width) do not divide by ``model_size``."""
    from ..models.attention import MultiheadAttention
    from ..models.modules import FFNLayer
    whole = []
    if model_size == 1:
        return whole
    for name, mod in model.named_modules():
        if isinstance(mod, MultiheadAttention):
            if mod.num_heads % model_size:
                whole.append(name)
                continue
            owners = ("qkv_transform",) if mod.is_self_attention else \
                ("q_transform", "kv_transform")
            for owner in owners + ("output_transform",):
                _split_linear(getattr(mod, owner), owner, rank, model_size,
                              group)
            mod.local_heads = mod.num_heads // model_size
            mod.head_offset = rank * mod.local_heads
            mod.tp_group = group
        elif isinstance(mod, FFNLayer):
            if mod.hidden_size % model_size:
                whole.append(name)
                continue
            for owner in ("input_layer", "output_layer"):
                _split_linear(getattr(mod, owner), owner, rank, model_size,
                              group)
            mod.hidden_offset = rank * (mod.hidden_size // model_size)
            mod.tp_group = group
    if whole:
        logging.warning("Tensor parallelism over %d ranks leaves these "
                        "layers whole on every rank (their heads or hidden "
                        "width do not divide): %s", model_size,
                        ", ".join(whole))
    return whole
