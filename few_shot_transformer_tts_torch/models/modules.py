"""Pre-LN transformer encoder and decoder stacks; counterpart of
``few_shot_transformer_tts_tpu/models/modules.py`` (reference
transformer/modules.py:8-145).

Per layer: LN -> self-attention -> residual; (decoder: LN -> cross-attention
-> residual;) LN -> FFN (4x, ReLU, bias-free) -> residual; then a final LN.
A learnable ``pe_scale`` multiplies the sinusoidal PE.  The decoder imputes
its targets and shifts them right by a zero frame before the PE, and exposes
the incremental path (``init_cache`` / ``precompute_memory`` /
``decode_step``) of the AR synthesizer.

With ``hp.remat`` the teacher-forced path runs each attention and each FFN
call under activation checkpointing (``remat_call``), as the JAX package
wraps ``MultiheadAttention`` and ``FFNLayer`` in ``nn.remat``: parameter
names, the state dict and the results are unchanged; the layers'
activations are recomputed in the backward instead of kept.  The norms
before them stay outside the recomputed region.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..ops.layernorm import LayerNorm
from .attention import Linear, MultiheadAttention
from .common import (
    causal_bias, column_parallel, dropout, impute, length_mask,
    padding_bias, row_parallel, sinusoid_position_encoding,
)


class FFNLayer(nn.Module):
    """Bias-free 2-layer ReLU FFN (reference transformer/modules.py:8-20).

    Under tensor parallelism (``parallel/sharding_rules.py:shard_model_``)
    ``input_layer`` holds hidden columns ``[hidden_offset, hidden_offset +
    local)`` of ``hidden_size`` and ``output_layer`` the matching rows, over
    the model group ``tp_group``; the hidden dropout keeps that slice of the
    whole layer's mask."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.input_layer = Linear(input_size, hidden_size, bias=False)
        self.output_layer = Linear(hidden_size, output_size, bias=False)
        self.dropout_rate = dropout_rate
        self.hidden_size = hidden_size
        self.hidden_offset = 0
        self.tp_group = None

    def forward(self, inputs, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        hidden = torch.relu(column_parallel(self.input_layer, inputs,
                                            self.tp_group))
        local = hidden.shape[-1]
        shard = None if local == self.hidden_size else \
            (hidden.dim() - 1, self.hidden_offset, self.hidden_size)
        hidden = dropout(hidden, self.dropout_rate, not deterministic,
                         generator, shard)
        return row_parallel(self.output_layer, hidden, self.tp_group)


def remat_call(layer, generator: Optional[torch.Generator], *args):
    """``layer(*args, generator)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant: the form that works
    under DDP).  The layer draws its dropout masks and the attention
    kernel's seed from ``generator``, which checkpoint's own RNG handling
    does not cover; so the generator's state at the forward is kept and set
    again for the recompute, which then draws what the forward drew and
    reproduces it bit for bit, and afterwards the generator goes back to
    where the backward found it."""
    if generator is None:
        return checkpoint(layer, *args, None, use_reentrant=False)
    start = generator.get_state()
    calls = []

    def run(*a):
        if not calls:       # the forward
            calls.append(True)
            return layer(*a, generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return layer(*a, generator)
        finally:
            generator.set_state(now)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _run(layer, remat: bool, generator, *args):
    """``layer(*args, generator)``, through ``remat_call`` with ``remat``."""
    if remat:
        return remat_call(layer, generator, *args)
    return layer(*args, generator)


def _attention(hp: Config, query_size: int, memory_size: int, size: int,
               is_self: bool) -> MultiheadAttention:
    return MultiheadAttention(
        query_size, memory_size, size, size, is_self, hp.n_attention_head,
        dropout_rate=hp.transformer_dropout_rate,
        use_kernel=hp.use_pallas_attention)


def _layer_norm(hp: Config, features: int) -> LayerNorm:
    """eps 1e-6 as the reference's nn.LayerNorm; ``hp.use_fused_layernorm``
    takes the backward kernel (the JAX package's ``FusedLayerNorm``)."""
    return LayerNorm(features, eps=1e-6, fused=hp.use_fused_layernorm)


class TransformerEncoder(nn.Module):
    """reference transformer/modules.py:23-69."""

    def __init__(self, input_size: int, hp: Config):
        super().__init__()
        hidden = hp.encoder_hidden
        self.rate = hp.transformer_dropout_rate
        self.remat = hp.remat
        sizes = [input_size] + [hidden] * (hp.n_encoder_layer - 1)
        self.self_attentions = nn.ModuleList(
            _attention(hp, s, s, s, True) for s in sizes)
        self.attn_layer_norms = nn.ModuleList(
            _layer_norm(hp, s) for s in sizes)
        self.ffn_layers = nn.ModuleList(
            FFNLayer(s, hidden * 4, hidden, self.rate) for s in sizes)
        self.ffn_layer_norms = nn.ModuleList(
            _layer_norm(hp, s) for s in sizes)
        self.output_layer_norm = _layer_norm(hp, hidden)
        self.pe_scale = nn.Parameter(torch.ones(1))

    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """inputs [B, T, C] embedded bytes -> encoder outputs [B, T, H]."""
        drop = lambda t: dropout(t, self.rate, not deterministic, generator)
        mask = length_mask(input_lengths, inputs.shape[1])
        x = inputs * mask[..., None].to(inputs.dtype)
        bias = padding_bias(mask)
        pe = sinusoid_position_encoding(x.shape[1], x.shape[2],
                                        x.device).to(x.dtype)
        x = drop(x + pe[None] * self.pe_scale.to(x.dtype))
        for i in range(len(self.self_attentions)):
            y, _ = _run(self.self_attentions[i], self.remat, generator,
                        self.attn_layer_norms[i](x), None, bias,
                        deterministic, False)
            x = x + drop(y)
            y = _run(self.ffn_layers[i], self.remat, generator,
                     self.ffn_layer_norms[i](x), deterministic)
            x = x + drop(y)
        return self.output_layer_norm(x)


class TransformerDecoder(nn.Module):
    """reference transformer/modules.py:72-145 plus the incremental path."""

    def __init__(self, input_size: int, hp: Config):
        super().__init__()
        hidden = hp.decoder_hidden
        # Inherited reference constraint (see the JAX package's decoder): the
        # prenet emits decoder_hidden while layer 0 is built at the memory
        # width, so the two must be equal.
        if input_size != hidden:
            raise ValueError(
                f"decoder_hidden ({hidden}) must equal encoder memory width "
                f"({input_size}) = encoder_hidden"
                " + speaker_embedding_size (if multi_speaker)"
                " + language_embedding_size (if multi_lingual)")
        self.hp = hp
        self.input_size = input_size
        self.rate = hp.transformer_dropout_rate
        self.remat = hp.remat
        n = hp.n_decoder_layer
        sizes = [input_size] + [hidden] * (n - 1)
        self.self_attentions = nn.ModuleList(
            _attention(hp, s, s, s, True) for s in sizes)
        self.attn_layer_norms = nn.ModuleList(
            _layer_norm(hp, s) for s in sizes)
        self.encdec_attentions = nn.ModuleList(
            _attention(hp, hidden, input_size, hidden, False) for _ in sizes)
        self.encdec_layer_norms = nn.ModuleList(
            _layer_norm(hp, hidden) for _ in sizes)
        self.ffn_layers = nn.ModuleList(
            FFNLayer(hidden, hidden * 4, hidden, self.rate) for _ in sizes)
        self.ffn_layer_norms = nn.ModuleList(
            _layer_norm(hp, hidden) for _ in sizes)
        self.output_layer_norm = _layer_norm(hp, hidden)
        self.pe_scale = nn.Parameter(torch.ones(1))

    # ---------------- teacher-forced path -----------------------------------

    def forward(self, memory: torch.Tensor, targets: torch.Tensor,
                input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                deterministic: bool = True, collect_alignments: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, List]]:
        """memory [B, Tin, H_mem]; targets [B, Tout, H] (already prenet'ed).

        Returns (outputs [B, Tout, H], {'self': [...], 'encdec': [...]}).
        """
        drop = lambda t: dropout(t, self.rate, not deterministic, generator)
        memory_bias = padding_bias(length_mask(input_lengths, memory.shape[1]))
        query_bias = causal_bias(targets.shape[1], targets.device)

        x = impute(targets, target_lengths)
        x = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        pe = sinusoid_position_encoding(x.shape[1], x.shape[2],
                                        x.device).to(x.dtype)
        x = drop(x + pe[None] * self.pe_scale.to(x.dtype))

        attn_align, encdec_align = [], []
        for i in range(len(self.self_attentions)):
            y, a = _run(self.self_attentions[i], self.remat, generator,
                        self.attn_layer_norms[i](x), None, query_bias,
                        deterministic, collect_alignments)
            attn_align.append(a)
            x = x + drop(y)
            y, a = _run(self.encdec_attentions[i], self.remat, generator,
                        self.encdec_layer_norms[i](x), memory, memory_bias,
                        deterministic, collect_alignments)
            encdec_align.append(a)
            x = x + drop(y)
            y = _run(self.ffn_layers[i], self.remat, generator,
                     self.ffn_layer_norms[i](x), deterministic)
            x = x + drop(y)
        outputs = impute(self.output_layer_norm(x), target_lengths)
        return outputs, {"self": attn_align, "encdec": encdec_align}

    # ---------------- incremental path --------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   device=None) -> Dict[str, torch.Tensor]:
        """Per-layer self-attention caches ``k_i``/``v_i`` [B, H, max_len, D]
        (fp32 storage of compute-dtype values) and the PE table ``pe``."""
        heads = self.hp.n_attention_head
        cache = {}
        for i, attn in enumerate(self.self_attentions):
            d = attn.key_size // heads
            cache[f"k_{i}"] = torch.zeros(batch, heads, max_len, d,
                                          device=device)
            cache[f"v_{i}"] = torch.zeros(batch, heads, max_len, d,
                                          device=device)
        cache["pe"] = sinusoid_position_encoding(max_len, self.hp.decoder_hidden,
                                                 device)
        return cache

    def precompute_memory(self, memory: torch.Tensor):
        """Cross-attention K/V per layer, computed once per utterance."""
        return [xa.project_kv(memory) for xa in self.encdec_attentions]

    def decode_step(self, x: torch.Tensor, step: int,
                    cache: Dict[str, torch.Tensor], memory_kv,
                    memory_bias: torch.Tensor, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None,
                    collect_self: bool = False):
        """One decoder step.  x [B, H] = prenet(prev_frame); the PE is added
        here.  Updates ``cache`` in place.  Returns (out [B, H],
        encdec_align [n_layers, B, heads, Tm], self_align [n_layers, B,
        heads, step + 1] (the pre-dropout self-attention weights) or None
        unless ``collect_self``)."""
        drop = lambda t: dropout(t, self.rate, not deterministic, generator)
        x = drop(x + cache["pe"][step].to(x.dtype) * self.pe_scale.to(x.dtype))
        aligns, self_aligns = [], []
        for i in range(len(self.self_attentions)):
            y, a = self.self_attentions[i].decode_self_step(
                self.attn_layer_norms[i](x), cache[f"k_{i}"], cache[f"v_{i}"],
                step, deterministic, generator)
            self_aligns.append(a)
            x = x + drop(y)
            y, a = self.encdec_attentions[i].decode_cross_step(
                self.encdec_layer_norms[i](x), memory_kv[i][0],
                memory_kv[i][1], memory_bias, deterministic, generator)
            aligns.append(a)
            x = x + drop(y)
            y = self.ffn_layers[i](self.ffn_layer_norms[i](x), deterministic,
                                   generator)
            x = x + drop(y)
        return self.output_layer_norm(x), torch.stack(aligns), \
            (torch.stack(self_aligns) if collect_self else None)
