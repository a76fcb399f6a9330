"""Plain reference of the Byte2Speech transformer TTS model (arXiv:2103.03541,
github.com/mutiann/few-shot-transformer-tts): encoder, decoder prenet,
decoder, mel and stop heads, postnet, and the training loss.

Plain PyTorch in float32, written from the published description and the
reference implementation's hyperparameters, with no kernels, caches or
batching tricks.  It imports nothing of the program under test.  Parameters
live in a flat dict keyed by the reference implementation's state-dict names
(``encoder.encoder.self_attentions.0.qkv_transform.weight`` ...), which is
also what the benchmark's weight generator fills and what the program's
model loads.

Model, per the reference:
  encoder   byte embedding (masked past each length), sinusoidal position
            encoding ([sin | cos], timescales 1 to 1e4) times a learned
            scale, pre-LN layers (self-attention, then a bias-free 4x ReLU
            FFN, each with dropout on its output and a residual), a final
            LN; then softsign speaker and language embeddings concatenated
            to every position;
  decoder   prenet (2 ReLU layers with dropout, a bias-free projection),
            targets zeroed past each length and shifted right by a zero
            frame, position encoding, pre-LN layers (causal self-attention,
            cross-attention over the encoder memory with its padding bias,
            FFN), a final LN zeroed past each length; a bias-free mel head
            and a stop head on the detached decoder output;
  postnet   5-tap bias-free convolutions, batch norm over the unpadded
            frames (running statistics in eval), tanh but after the last,
            dropout; the mel after the postnet is mel + postnet(mel).
Attention: queries scaled by head_dim ** -0.5, additive bias of -1e20,
softmax, dropout on the weights.

Products go through ``Q``, the rounding applied to both operands of every
product (``exact`` leaves them as they are; ``Fp8`` rounds them as the
control of the correctness check does).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

NEG_INF = -1e20


def hparams(values: dict) -> SimpleNamespace:
    """The configuration file's values as attributes."""
    return SimpleNamespace(**values)


def memory_width(hp) -> int:
    return hp.encoder_hidden + \
        (hp.speaker_embedding_size if hp.multi_speaker else 0) + \
        (hp.language_embedding_size if hp.multi_lingual else 0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(hp) -> list:
    """[(name, shape, init)] of every parameter and buffer, in the
    reference's state-dict order.  init: "dense" (variance scaling, fan
    average, factor 2.6, truncated at 2 std), "normal" (N(0, 1)), "half"
    (0.5 x a unit normal truncated at 2), "zeros", "ones", "stop_bias",
    "count" (an integer zero)."""
    spec = []
    add = lambda name, shape, init: spec.append((name, tuple(shape), init))

    def norm(prefix, c):
        add(prefix + ".weight", (c,), "ones")
        add(prefix + ".bias", (c,), "zeros")

    def attention(prefix, q_in, m_in, size, is_self):
        if is_self:
            add(prefix + ".qkv_transform.weight", (3 * size, q_in), "dense")
        else:
            add(prefix + ".q_transform.weight", (size, q_in), "dense")
            add(prefix + ".kv_transform.weight", (2 * size, m_in), "dense")
        add(prefix + ".output_transform.weight", (size, size), "dense")

    def ffn(prefix, c_in, hidden, c_out):
        add(prefix + ".input_layer.weight", (hidden, c_in), "dense")
        add(prefix + ".output_layer.weight", (c_out, hidden), "dense")

    e, he, hd = hp.embed_size, hp.encoder_hidden, hp.decoder_hidden
    add("encoder.embed.weight", (hp.vocab_size, e), "normal")
    if hp.multi_speaker:
        s = hp.speaker_embedding_size
        add("encoder.speaker_embed.weight", (hp.max_num_speaker, s), "half")
        add("encoder.speaker_layer.weight", (s, s), "dense")
        add("encoder.speaker_layer.bias", (s,), "zeros")
    if hp.multi_lingual:
        g = hp.language_embedding_size
        add("encoder.language_embed.weight", (g, hp.max_num_language), "half")
        add("encoder.language_layer.weight", (g, g), "dense")
        add("encoder.language_layer.bias", (g,), "zeros")
    sizes = [e] + [he] * (hp.n_encoder_layer - 1)
    for i, s in enumerate(sizes):
        p = "encoder.encoder."
        attention(p + "self_attentions.%d" % i, s, s, s, True)
        norm(p + "attn_layer_norms.%d" % i, s)
        ffn(p + "ffn_layers.%d" % i, s, 4 * he, he)
        norm(p + "ffn_layer_norms.%d" % i, s)
    norm("encoder.encoder.output_layer_norm", he)
    add("encoder.encoder.pe_scale", (1,), "ones")

    m = memory_width(hp)
    ph = hp.prenet_hidden
    add("decoder.prenet.dense0.weight", (ph, hp.num_mels), "dense")
    add("decoder.prenet.dense0.bias", (ph,), "zeros")
    add("decoder.prenet.dense1.weight", (ph, ph), "dense")
    add("decoder.prenet.dense1.bias", (ph,), "zeros")
    add("decoder.prenet.dense_final.weight", (hd, ph), "dense")
    sizes = [m] + [hd] * (hp.n_decoder_layer - 1)
    for i, s in enumerate(sizes):
        p = "decoder.decoder."
        attention(p + "self_attentions.%d" % i, s, s, s, True)
        norm(p + "attn_layer_norms.%d" % i, s)
    for i in range(len(sizes)):
        p = "decoder.decoder."
        attention(p + "encdec_attentions.%d" % i, hd, m, hd, False)
        norm(p + "encdec_layer_norms.%d" % i, hd)
        ffn(p + "ffn_layers.%d" % i, hd, 4 * hd, hd)
        norm(p + "ffn_layer_norms.%d" % i, hd)
    norm("decoder.decoder.output_layer_norm", hd)
    add("decoder.decoder.pe_scale", (1,), "ones")
    add("decoder.mel_net.weight", (hp.num_mels, hd), "dense")
    add("decoder.stop_net.weight", (1, hd), "dense")
    add("decoder.stop_net.bias", (1,), "stop_bias")

    for i, (c_in, c_out) in enumerate(postnet_channels(hp)):
        add("postnet.conv_layers.%d.weight" % i, (c_out, c_in, 5), "dense")
    for i, (_, c_out) in enumerate(postnet_channels(hp)):
        p = "postnet.batchnorm_layers.%d." % i
        add(p + "weight", (c_out,), "ones")
        add(p + "bias", (c_out,), "zeros")
        add(p + "running_mean", (c_out,), "zeros")
        add(p + "running_var", (c_out,), "ones")
        add(p + "num_batches_tracked", (), "count")
    return spec


def postnet_channels(hp) -> list:
    n = hp.n_postnet_layer
    ins = [hp.num_mels] + [hp.postnet_hidden] * (n - 1)
    outs = [hp.postnet_hidden] * (n - 1) + [hp.num_mels]
    return list(zip(ins, outs))


BUFFER_LEAVES = ("running_mean", "running_var", "num_batches_tracked")
EMBEDDING_TABLES = ("encoder.embed.weight", "encoder.speaker_embed.weight")


def is_parameter(name: str) -> bool:
    return name.rsplit(".", 1)[-1] not in BUFFER_LEAVES


def is_l2_weight(name: str, shape) -> bool:
    """The weights of the dense and convolution layers, which the loss's L2
    term covers (the language projection is a dense layer; the lookup
    tables, norms, biases and scales are not)."""
    return name.endswith(".weight") and len(shape) >= 2 and \
        name not in EMBEDDING_TABLES


# ---------------------------------------------------------------------------
# rounding of product operands
# ---------------------------------------------------------------------------

def exact(x):
    return x


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        return (x * scale).clamp(-448.0, 448.0).to(
            torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude to 448); the gradient passes unchanged."""
    return _Fp8Round.apply(x)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def sinusoid(length: int, channels: int, device) -> torch.Tensor:
    position = torch.arange(length, dtype=torch.float64)
    n = channels // 2
    inc = math.log(1e4) / (n - 1)
    inv = torch.exp(torch.arange(n, dtype=torch.float64) * -inc)
    t = position[:, None] * inv[None, :]
    sig = torch.cat([torch.sin(t), torch.cos(t)], dim=1)
    sig = F.pad(sig, (0, channels % 2))
    return sig.float().to(device)


def length_mask(lengths, t: int):
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def impute(x, lengths):
    m = length_mask(lengths, x.shape[1])
    return x * m.reshape(m.shape + (1,) * (x.dim() - 2)).to(x.dtype)


def linear(x, w, b=None, Q=exact):
    return F.linear(Q(x), Q(w), b)


def layer_norm(P, prefix, x):
    return F.layer_norm(x, (x.shape[-1],), P[prefix + ".weight"],
                        P[prefix + ".bias"], 1e-6)


class NoDropout:
    """Dropout off (eval)."""

    def apply(self, name, x, rate):
        return x

    def attn(self, name, w, rate):
        return w


def attention(P, prefix, xq, xm, bias, causal, heads, Q, drop, name, rate):
    if xm is None:
        q, k, v = linear(xq, P[prefix + ".qkv_transform.weight"],
                         Q=Q).chunk(3, -1)
    else:
        q = linear(xq, P[prefix + ".q_transform.weight"], Q=Q)
        k, v = linear(xm, P[prefix + ".kv_transform.weight"],
                      Q=Q).chunk(2, -1)
    b, tq, c = q.shape
    tk, d = k.shape[1], c // heads
    split = lambda t, n: t.reshape(b, n, heads, d).transpose(1, 2)
    qh = split(q, tq) * d ** -0.5
    s = torch.matmul(Q(qh), Q(split(k, tk)).transpose(-1, -2))
    if bias is not None:
        s = s + bias
    if causal:
        above = torch.ones(tq, tk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    w = drop.attn(name, torch.softmax(s, -1), rate)
    ctx = torch.matmul(Q(w), Q(split(v, tk)))
    ctx = ctx.transpose(1, 2).reshape(b, tq, c)
    return linear(ctx, P[prefix + ".output_transform.weight"], Q=Q)


def ffn(P, prefix, x, Q, drop, name, rate):
    h = torch.relu(linear(x, P[prefix + ".input_layer.weight"], Q=Q))
    h = drop.apply(name, h, rate)
    return linear(h, P[prefix + ".output_layer.weight"], Q=Q)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def encoder(P, hp, inputs, lengths, spk=None, lvec=None, Q=exact,
            drop=NoDropout()):
    """inputs [b, T] byte ids -> memory [b, T, memory_width]."""
    rate = hp.transformer_dropout_rate
    b, t = inputs.shape
    mask = length_mask(lengths, t)
    x = P["encoder.embed.weight"][inputs.long()] * mask[..., None]
    bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :]
    x = x + sinusoid(t, x.shape[-1], x.device) * \
        P["encoder.encoder.pe_scale"]
    x = drop.apply("enc.pe", x, rate)
    p = "encoder.encoder."
    for i in range(hp.n_encoder_layer):
        y = attention(P, p + "self_attentions.%d" % i,
                      layer_norm(P, p + "attn_layer_norms.%d" % i, x), None,
                      bias, False, hp.n_attention_head, Q, drop,
                      "enc.%d.attn" % i, rate)
        x = x + drop.apply("enc.%d.attn_out" % i, y, rate)
        y = ffn(P, p + "ffn_layers.%d" % i,
                layer_norm(P, p + "ffn_layer_norms.%d" % i, x), Q, drop,
                "enc.%d.ffn_hidden" % i, rate)
        x = x + drop.apply("enc.%d.ffn_out" % i, y, rate)
    x = layer_norm(P, p + "output_layer_norm", x)
    parts = [x]
    if hp.multi_speaker:
        e = P["encoder.speaker_embed.weight"][spk.long()]
        e = F.softsign(linear(e, P["encoder.speaker_layer.weight"],
                              P["encoder.speaker_layer.bias"], Q))
        parts.append(e[:, None, :].expand(b, t, -1))
    if hp.multi_lingual:
        e = linear(lvec, P["encoder.language_embed.weight"], Q=Q)
        e = F.softsign(linear(e, P["encoder.language_layer.weight"],
                              P["encoder.language_layer.bias"], Q))
        parts.append(e[:, None, :].expand(b, t, -1))
    return torch.cat(parts, -1)


def prenet(P, x, Q, drop, rate):
    p = "decoder.prenet."
    x = torch.relu(linear(x, P[p + "dense0.weight"], P[p + "dense0.bias"], Q))
    x = drop.apply("dec.prenet0", x, rate)
    x = torch.relu(linear(x, P[p + "dense1.weight"], P[p + "dense1.bias"], Q))
    x = drop.apply("dec.prenet1", x, rate)
    return linear(x, P[p + "dense_final.weight"], Q=Q)


def decoder_layers(P, hp, x, memory, mem_bias, Q, drop):
    rate = hp.transformer_dropout_rate
    p = "decoder.decoder."
    for i in range(hp.n_decoder_layer):
        y = attention(P, p + "self_attentions.%d" % i,
                      layer_norm(P, p + "attn_layer_norms.%d" % i, x), None,
                      None, True, hp.n_attention_head, Q, drop,
                      "dec.%d.self" % i, rate)
        x = x + drop.apply("dec.%d.self_out" % i, y, rate)
        y = attention(P, p + "encdec_attentions.%d" % i,
                      layer_norm(P, p + "encdec_layer_norms.%d" % i, x),
                      memory, mem_bias, False, hp.n_attention_head, Q, drop,
                      "dec.%d.cross" % i, rate)
        x = x + drop.apply("dec.%d.cross_out" % i, y, rate)
        y = ffn(P, p + "ffn_layers.%d" % i,
                layer_norm(P, p + "ffn_layer_norms.%d" % i, x), Q, drop,
                "dec.%d.ffn_hidden" % i, rate)
        x = x + drop.apply("dec.%d.ffn_out" % i, y, rate)
    return layer_norm(P, p + "output_layer_norm", x)


def heads(P, out, Q):
    """(mel, stop logit) of decoder outputs; the stop head reads them
    detached."""
    mel = linear(out, P["decoder.mel_net.weight"], Q=Q)
    stop = linear(out.detach(), P["decoder.stop_net.weight"],
                  P["decoder.stop_net.bias"], Q)[..., 0]
    return mel, stop


def decoder_teacher_forced(P, hp, memory, in_lengths, targets, tgt_lengths,
                           Q=exact, drop=NoDropout()):
    """The training decoder over whole target sequences: (mel [b, T, M],
    stop logits [b, T]), zero past each length."""
    x = prenet(P, targets, Q, drop, hp.decoder_dropout_rate)
    x = impute(x, tgt_lengths)
    x = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
    t = x.shape[1]
    x = x + sinusoid(t, x.shape[-1], x.device) * \
        P["decoder.decoder.pe_scale"]
    x = drop.apply("dec.pe", x, hp.transformer_dropout_rate)
    mem_bias = torch.where(length_mask(in_lengths, memory.shape[1]), 0.0,
                           NEG_INF)[:, None, None, :]
    out = impute(decoder_layers(P, hp, x, memory, mem_bias, Q, drop),
                 tgt_lengths)
    mel, stop = heads(P, out, Q)
    return impute(mel, tgt_lengths), impute(stop, tgt_lengths)


def decoder_on_frames(P, hp, memory, frames, Q=exact):
    """What autoregressive decoding predicts at each position when fed
    ``frames`` [b, T, M] as its previous outputs: the input of step t is
    the prenet of frame t - 1 (of a zero frame at t = 0) plus the position
    encoding of t.  ``memory`` [b, T_in, C] is unpadded.  (mel, stop)."""
    prev = torch.cat([torch.zeros_like(frames[:, :1]), frames[:, :-1]], 1)
    x = prenet(P, prev, Q, NoDropout(), 0.0)
    x = x + sinusoid(x.shape[1], x.shape[-1], x.device) * \
        P["decoder.decoder.pe_scale"]
    out = decoder_layers(P, hp, x, memory, None, Q, NoDropout())
    return heads(P, out, Q)


def postnet(P, hp, x, lengths, train=False, Q=exact, drop=NoDropout()):
    """The postnet's residual [b, T, M] of mels x."""
    n = hp.n_postnet_layer
    for i in range(n):
        x = impute(x, lengths)
        x = F.conv1d(Q(x).transpose(1, 2),
                     Q(P["postnet.conv_layers.%d.weight" % i]),
                     padding=2).transpose(1, 2)
        p = "postnet.batchnorm_layers.%d." % i
        if train:
            m = length_mask(lengths, x.shape[1]).float()[..., None]
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum((0, 1)) / cnt
            var = (torch.square(x - mean) * m).sum((0, 1)) / cnt
        else:
            mean, var = P[p + "running_mean"], P[p + "running_var"]
        x = (x - mean) * torch.rsqrt(var + 1e-5) * P[p + "weight"] + \
            P[p + "bias"]
        if i != n - 1:
            x = torch.tanh(x)
        x = drop.apply("post.%d" % i, x, hp.decoder_dropout_rate if train
                       else 0.0)
    return x


def masked_mean(loss, lengths, count):
    return impute(loss, lengths).sum() / count


def stop_loss_sum(stop, lengths):
    """The masked sum of the stop head's weighted binary cross-entropy
    (positive weight 5 on each row's last frame)."""
    t = stop.shape[1]
    target = (torch.arange(t, device=stop.device)[None, :] ==
              (lengths[:, None] - 1)).float()
    ce = 5.0 * target * F.softplus(-stop) + (1 - target) * F.softplus(stop)
    return impute(ce, lengths).sum()


def l2_term(P, hp):
    total = 0.0
    for name, w in P.items():
        if is_l2_weight(name, w.shape):
            total = total + torch.sum(torch.square(w)) / 2
    return hp.reg_weight * total
