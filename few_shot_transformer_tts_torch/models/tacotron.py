"""Byte2Speech transformer model (encoder, prenet, decoder, postnet) as
nn.Modules; counterpart of ``few_shot_transformer_tts_tpu/models/tacotron.py``
(reference transformer/tacotron.py:8-133).

Submodule names are the reference torch state-dict names (for example
``encoder.encoder.self_attentions.0.qkv_transform.weight``,
``postnet.batchnorm_layers.3.running_mean``), so a reference checkpoint loads
with ``load_state_dict(strict=True)`` and ``train/converter.py`` maps the
JAX package's variables one to one.

Compute runs in ``hp.use_bfloat16`` ? bf16 : fp32 (the modules' ``dtype``);
parameters are fp32.  LN/BN statistics, softmax, biases and ``pe_scale``
stay fp32 as in the JAX package; mel and stop outputs are fp32.

Training (reference transformer/tacotron.py:136-179): ``compute_loss`` (bef/
aft masked MSE, masked stop BCE with pos_weight 5, L2 over the Linear and
Conv1d weights), ``learning_rate_schedule``, and ``MaskedBatchNorm``'s
length-masked batch statistics.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from ..config import Config
from ..utils.device import resolve_device
from .attention import Linear
from .common import dropout, impute, length_mask, mask_reduce, \
    model_parallel_sum, spans_ranks
from .modules import TransformerDecoder, TransformerEncoder


class Embedding(nn.Embedding):
    """nn.Embedding whose lookups come out in ``dtype`` (flax Embed)."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__(num, dim)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class Conv1d(nn.Conv1d):
    """Bias-free k-tap SAME Conv1d over [B, T, C] inputs, computing in the
    input's dtype (flax nn.Conv on NWC)."""

    def __init__(self, in_size: int, out_size: int, kernel_size: int = 5):
        super().__init__(in_size, out_size, kernel_size,
                         padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype),
                     padding=self.padding)
        return y.transpose(1, 2)


class Encoder(nn.Module):
    """reference transformer/tacotron.py:8-44."""

    def __init__(self, hp: Config, dtype: torch.dtype):
        super().__init__()
        self.hp = hp
        self.dtype = dtype
        self.embed = Embedding(hp.vocab_size, hp.embed_size, dtype)
        if hp.multi_speaker:
            self.speaker_embed = Embedding(hp.max_num_speaker,
                                           hp.speaker_embedding_size, dtype)
            self.speaker_layer = Linear(hp.speaker_embedding_size,
                                        hp.speaker_embedding_size)
        if hp.multi_lingual:
            self.language_embed = Linear(hp.max_num_language,
                                         hp.language_embedding_size,
                                         bias=False)
            self.language_layer = Linear(hp.language_embedding_size,
                                         hp.language_embedding_size)
        self.encoder = TransformerEncoder(hp.embed_size, hp)

    def forward(self, inputs, input_lengths, input_spk_ids=None,
                input_language_vecs=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        out = self.encoder(self.embed(inputs), input_lengths, deterministic,
                           generator)
        b, t = out.shape[:2]
        if self.hp.multi_speaker:
            spk = F.softsign(self.speaker_layer(
                self.speaker_embed(input_spk_ids)))
            out = torch.cat([out, spk[:, None, :].expand(b, t, -1)], dim=-1)
        if self.hp.multi_lingual:
            lan = F.softsign(self.language_layer(self.language_embed(
                input_language_vecs.to(self.dtype))))
            out = torch.cat([out, lan[:, None, :].expand(b, t, -1)], dim=-1)
        return out


class DecoderPrenet(nn.Module):
    """reference transformer/tacotron.py:47-65."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int,
                 dropout_rate: float):
        super().__init__()
        self.dense0 = Linear(in_size, hidden_size)
        self.dense1 = Linear(hidden_size, hidden_size)
        self.dense_final = Linear(hidden_size, out_size, bias=False)
        self.rate = dropout_rate

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = dropout(torch.relu(self.dense0(x)), self.rate, not deterministic,
                    generator)
        x = dropout(torch.relu(self.dense1(x)), self.rate, not deterministic,
                    generator)
        return self.dense_final(x)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) with padded frames excluded from the
    batch statistics (the JAX package's divergence from torch BatchNorm1d:
    the train step does not depend on how much lattice padding a batch
    carries).  Normalization uses the biased variance; the running
    statistics take ``0.9 * old + 0.1 * new`` with the unbiased variance,
    outside autograd.  Eval uses the running statistics.  Buffers carry the
    torch names, ``num_batches_tracked`` included, so reference checkpoints
    load.

    With a ``group`` of more than one rank (data-parallel training) the
    statistics are those of every rank's unmasked frames, as the JAX step's
    reduction over its sharded batch axis gives them: one all-reduce of
    (sum of x, frame count), then one of the squared deviations, both
    through ``torch.distributed.nn.functional.all_reduce`` so that the
    backward sums the statistics' gradients over the ranks.  The unbiased
    factor takes the global count, so the running statistics come out the
    same on every rank.
    """

    def __init__(self, features: int, dtype: torch.dtype, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x, lengths, use_running_average: bool = True,
                group=None):
        xf = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            mask = length_mask(lengths, x.shape[1]).float()[..., None]
            if spans_ranks(group):
                from torch.distributed.nn.functional import all_reduce
                sums = all_reduce(torch.cat([(xf * mask).sum((0, 1)),
                                             mask.sum().reshape(1)]),
                                  group=group)
                n = torch.clamp(sums[-1], min=1.0)
                mean = sums[:-1] / n
                var = all_reduce(
                    (torch.square(xf - mean) * mask).sum((0, 1)),
                    group=group) / n
            else:
                n = torch.clamp(mask.sum(), min=1.0)
                mean = (xf * mask).sum((0, 1)) / n
                var = (torch.square(xf - mean) * mask).sum((0, 1)) / n
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.copy_(self.momentum * self.running_mean +
                                        (1.0 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var +
                                       (1.0 - self.momentum) * unbiased)
                self.num_batches_tracked.add_(1)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


class Postnet(nn.Module):
    """reference transformer/tacotron.py:68-90; layout [B, T, C]."""

    def __init__(self, hp: Config, dtype: torch.dtype):
        super().__init__()
        n = hp.n_postnet_layer
        ins = [hp.num_mels] + [hp.postnet_hidden] * (n - 1)
        outs = [hp.postnet_hidden] * (n - 1) + [hp.num_mels]
        self.conv_layers = nn.ModuleList(
            Conv1d(i, o, 5) for i, o in zip(ins, outs))
        self.batchnorm_layers = nn.ModuleList(
            MaskedBatchNorm(o, dtype) for o in outs)
        self.rate = hp.decoder_dropout_rate

    def forward(self, inputs, input_lengths, train: bool = False,
                generator: Optional[torch.Generator] = None, group=None):
        x = inputs
        n = len(self.conv_layers)
        for i in range(n):
            x = self.conv_layers[i](impute(x, input_lengths))
            x = self.batchnorm_layers[i](x, input_lengths,
                                         use_running_average=not train,
                                         group=group)
            if i != n - 1:
                x = torch.tanh(x)
            x = dropout(x, self.rate, train, generator)
        return x


class Decoder(nn.Module):
    """reference transformer/tacotron.py:93-116."""

    def __init__(self, hp: Config):
        super().__init__()
        in_size = hp.encoder_hidden
        if hp.multi_speaker:
            in_size += hp.speaker_embedding_size
        if hp.multi_lingual:
            in_size += hp.language_embedding_size
        self.prenet = DecoderPrenet(hp.num_mels, hp.prenet_hidden,
                                    hp.decoder_hidden, hp.decoder_dropout_rate)
        self.decoder = TransformerDecoder(in_size, hp)
        self.mel_net = Linear(hp.decoder_hidden, hp.num_mels, bias=False)
        self.stop_net = Linear(hp.decoder_hidden, 1)

    def forward(self, encoder_outputs, input_lengths, targets, target_lengths,
                deterministic: bool = True, collect_alignments: bool = False,
                generator: Optional[torch.Generator] = None):
        dec_inputs = self.prenet(targets, deterministic, generator)
        outputs, align = self.decoder(
            encoder_outputs, dec_inputs, input_lengths, target_lengths,
            deterministic, collect_alignments, generator)
        mels = impute(self.mel_net(outputs), target_lengths)
        stop_logits = impute(self.stop_net(outputs.detach())[..., 0],
                             target_lengths)
        return mels, stop_logits, align


class ByteToMel(nn.Module):
    """Top-level model (reference transformer/tacotron.py:119-133
    'Tacotron').  Built on ``device`` ("cuda" unless the caller asks for the
    CPU; a missing card raises)."""

    def __init__(self, hp: Config, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.hp = hp
        self.dtype = torch.bfloat16 if hp.use_bfloat16 else torch.float32
        self.encoder = Encoder(hp, self.dtype)
        self.decoder = Decoder(hp)
        self.postnet = Postnet(hp, self.dtype)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.postnet.batchnorm_layers[0].running_mean.device

    def forward(self, inputs, input_lengths, mel_targets, target_lengths,
                input_spk_ids=None, input_language_vecs=None,
                train: bool = False, decoder_dropout: Optional[bool] = None,
                collect_alignments: bool = False,
                generator: Optional[torch.Generator] = None, group=None
                ) -> Dict[str, Any]:
        """Teacher-forced forward.  All float outputs are fp32.  ``group``:
        the process group whose ranks' rows share the postnet's BatchNorm
        statistics in training (``MaskedBatchNorm``)."""
        if decoder_dropout is None:
            decoder_dropout = train
        enc = self.encoder(inputs, input_lengths, input_spk_ids,
                           input_language_vecs, not train, generator)
        mel_bef, stop_logits, alignments = self.decoder(
            enc, input_lengths, mel_targets.to(self.dtype), target_lengths,
            deterministic=not decoder_dropout,
            collect_alignments=collect_alignments, generator=generator)
        mel_res = self.postnet(mel_bef, target_lengths, train=train,
                               generator=generator, group=group)
        mel_bef = mel_bef.float()
        return {"mel_bef": mel_bef, "mel_aft": mel_bef + mel_res.float(),
                "stop_logits": stop_logits.float(),
                "alignments": alignments}

    # ------------- incremental synthesis entry points ----------------------

    def encode(self, inputs, input_lengths, input_spk_ids=None,
               input_language_vecs=None):
        """Encoder once plus the cross-attention K/V of every decoder layer."""
        enc = self.encoder(inputs, input_lengths, input_spk_ids,
                           input_language_vecs, deterministic=True)
        return enc, self.decoder.decoder.precompute_memory(enc)

    def init_decode_cache(self, batch: int, max_len: int):
        return self.decoder.decoder.init_cache(batch, max_len, self.device)

    def decode_step(self, prev_mel, step: int, cache, memory_kv, memory_bias,
                    decoder_dropout: bool = False,
                    generator: Optional[torch.Generator] = None,
                    finished: Optional[torch.Tensor] = None,
                    collect_self: bool = False):
        """One AR step: prev_mel [B, M] -> (mel [B, M], stop_logit [B],
        encdec_align [n_layers, B, H, Tm], self_align [n_layers, B, H,
        step + 1] or None unless ``collect_self``); ``cache`` is updated in
        place.  Rows where ``finished`` [B] is True feed zeros to the decoder
        (the reference imputes prenet outputs beyond frozen target lengths,
        modules.py:114, synthesize.py:39-45)."""
        deterministic = not decoder_dropout
        x = self.decoder_inputs(prev_mel, finished, deterministic, generator)
        out, align, self_align = self.decoder.decoder.decode_step(
            x, step, cache, memory_kv, memory_bias, deterministic, generator,
            collect_self)
        mel, stop = self.decoder_outputs(out)
        return mel, stop, align, self_align

    def decoder_inputs(self, prev_mel, finished=None,
                       deterministic: bool = True,
                       generator: Optional[torch.Generator] = None):
        """The prenet of the previous frame, zeros for ``finished`` rows."""
        x = self.decoder.prenet(prev_mel.to(self.dtype), deterministic,
                                generator)
        if finished is not None:
            x = torch.where(finished[:, None], torch.zeros_like(x), x)
        return x

    def decoder_outputs(self, out):
        """(mel [B, M], stop_logit [B]) fp32 of the decoder output."""
        return (self.decoder.mel_net(out).float(),
                self.decoder.stop_net(out)[..., 0].float())

    def postnet_residual(self, mels, lengths, train: bool = False):
        return self.postnet(mels.to(self.dtype), lengths, train=train).float()


# ---------------------------------------------------------------------------
# initialization (reference transformer/common.py:90-124, tacotron.py:161-173)
# ---------------------------------------------------------------------------


def _truncated_normal(rng: np.random.RandomState, shape) -> np.ndarray:
    """Unit normal truncated to +-2 (resampling the tails)."""
    x = rng.standard_normal(shape)
    while True:
        out = np.abs(x) > 2.0
        if not out.any():
            return x
        x[out] = rng.standard_normal(int(out.sum()))


def init_weights_(model: ByteToMel, seed: int) -> ByteToMel:
    """Fill every parameter and buffer from ``numpy.random.RandomState(seed)``
    with the JAX package's initializers: variance scaling (fan_avg, factor
    2 x 1.3, truncated at 2 std) for Linear/Conv weights, N(0, 1) for the byte
    embedding, truncated N(0, 0.5) for the speaker embedding and the language
    projection; zeros for biases, ones for norm scales and ``pe_scale``."""
    rng = np.random.RandomState(seed)
    trunc_half = (model.encoder.speaker_embed.weight
                  if model.hp.multi_speaker else None,
                  model.encoder.language_embed.weight
                  if model.hp.multi_lingual else None)
    with torch.no_grad():
        for mod in model.modules():
            w = getattr(mod, "weight", None)
            if isinstance(mod, (Linear, Conv1d, Embedding)):
                shape = tuple(w.shape)
                if any(w is t for t in trunc_half):
                    val = 0.5 * _truncated_normal(rng, shape)
                elif mod is model.encoder.embed:
                    val = rng.standard_normal(shape)
                else:
                    fan_in = int(np.prod(shape[1:]))
                    fan_out = shape[0] * int(np.prod(shape[2:]))
                    std = np.sqrt(1.3 * 2.0 / ((fan_in + fan_out) / 2.0))
                    val = std * _truncated_normal(rng, shape)
                w.copy_(torch.from_numpy(val.astype(np.float32)))
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "pe_scale" or leaf == "running_var" or (
                    leaf == "weight" and "norm" in name):
                t.fill_(1.0)
            elif leaf in ("running_mean", "num_batches_tracked") or (
                    leaf == "bias" and "norm" in name):
                t.zero_()
    return model


# ---------------------------------------------------------------------------
# loss and LR schedule (reference transformer/tacotron.py:136-179)
# ---------------------------------------------------------------------------


def l2_loss(model: nn.Module) -> torch.Tensor:
    """sum(w^2) / 2 over the Linear and Conv1d weights (the JAX package's
    Dense/Conv ``kernel`` leaves); embeddings, norms, biases and
    ``pe_scale`` are excluded (reference tacotron.py:144-146).  The terms
    of tensor-parallel weights (``param.tp``) are summed over their model
    group, so every rank gets the whole model's value, and each its own
    slices' gradient."""
    total, split, group = 0.0, 0.0, None
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            term = torch.sum(torch.square(mod.weight.float())) / 2
            spec = getattr(mod.weight, "tp", None)
            if spec is None:
                total = total + term
            else:
                split, group = split + term, spec.group
    if group is not None:
        total = total + model_parallel_sum(split, group)
    return total


def compute_loss(model: nn.Module, mel_targets, target_lengths, outputs,
                 hp: Config, group=None) -> Dict[str, torch.Tensor]:
    """The JAX package's ``compute_loss``: loss = bef + aft + L2 + stop.

    With a ``group`` of W > 1 ranks (data-parallel training, each rank
    holding its own rows), every masked mean divides this rank's sum by the
    frame count of all ranks (``mask_reduce``), and the dict gains
    ``objective``, what this rank differentiates: W x (its bef + aft +
    stop terms) + L2 once.  DDP averages the ranks' gradients, so the
    result is the gradient of the JAX package's loss over the global batch.
    The other entries are then the global losses, detached: the rank terms
    all-reduced on the device, with no host sync.  ``aft_losses`` stays
    this rank's per-sample values."""
    bef = torch.mean(torch.square(outputs["mel_bef"] - mel_targets), dim=-1)
    bef_loss = mask_reduce(bef, target_lengths, group=group)
    aft = torch.mean(torch.square(outputs["mel_aft"] - mel_targets), dim=-1)
    aft_loss_samplewise = mask_reduce(aft, target_lengths, per_sample=True)
    aft_loss = mask_reduce(aft, target_lengths, group=group)
    l2_reg = hp.reg_weight * l2_loss(model)

    t = mel_targets.shape[1]
    stop_target = (torch.arange(t, device=mel_targets.device)[None, :] ==
                   (target_lengths[:, None] - 1)).float()
    x = outputs["stop_logits"]
    # BCE-with-logits, pos_weight=5 (reference tacotron.py:150-151)
    ce = 5.0 * stop_target * F.softplus(-x) + \
        (1.0 - stop_target) * F.softplus(x)
    ce_loss = mask_reduce(ce, target_lengths, group=group)

    extra = {}
    if spans_ranks(group):
        world = dist.get_world_size(group)
        extra["objective"] = world * (bef_loss + aft_loss + ce_loss) + l2_reg
        terms = torch.stack([bef_loss, aft_loss, ce_loss]).detach()
        dist.all_reduce(terms, group=group)
        bef_loss, aft_loss, ce_loss = terms.unbind()
        l2_reg = l2_reg.detach()
        aft_loss_samplewise = aft_loss_samplewise.detach()
    mse_loss = (bef_loss + aft_loss) / 2
    loss = bef_loss + aft_loss + l2_reg + ce_loss
    return {"loss": loss, "bef_loss": bef_loss, "aft_loss": aft_loss,
            "aft_losses": aft_loss_samplewise, "mse_loss": mse_loss,
            "l2": l2_reg, "stop_loss": ce_loss, **extra}


def lr_factor(global_step: int, hp: Config) -> float:
    """The LR at a step over ``hp.max_lr`` (reference tacotron.py:176-179)."""
    step = max(global_step - hp.warmup_steps, 0)
    rate = hp.lr_decay_rate ** (step / hp.lr_decay_step)
    return max(hp.min_lr / hp.max_lr, rate)


def learning_rate_schedule(global_step: int, hp: Config) -> float:
    """Absolute LR at a step (reference tacotron.py:176-179 x max_lr)."""
    return hp.max_lr * lr_factor(global_step, hp)
