"""F5-TTS (arXiv:2410.06885; the ``F5TTS_Base`` DiT of
github.com/SWivid/F5-TTS): a diffusion transformer that predicts the
flow-matching velocity of a whole mel spectrogram at once, conditioned on a
prompt mel, the text, and the flow time.  Synthesis runs it as an ODE
(``infer/flow.py``); there is no frame loop, stop head or KV cache.

Submodule names are F5's own state-dict names (``time_embed.time_mlp.0``,
``text_embed.text_blocks.<i>.grn.gamma``, ``transformer_blocks.<i>.attn.to_q``,
``transformer_blocks.<i>.ff.ff.0.0`` ...), less F5's ``transformer.``
prefix.

  text embedding  ids are UTF-8 bytes (0-255, -1 past the text); id + 1
                  indexes a (256 + 1)-row table whose row 0 is the filler
                  that pads the text to the mel length.  A [cos | sin]
                  position signal (base 10000) is added, then
                  ``text_conv_layers`` ConvNeXt-V2 blocks: depthwise conv
                  k=7, LayerNorm, Linear to ``TEXT_CONV_MULT`` x, GELU,
                  global response norm (GRN), Linear back, residual.
  input           [x_t ; prompt mel ; text] -> Linear to ``dit_dim``, plus a
                  residual of two grouped convs (``CONV_POS_KERNEL``,
                  ``CONV_POS_GROUPS``), each followed by Mish.
  time            a sinusoid of 1000 t (256 wide) -> Linear, SiLU, Linear.
  DiT blocks      AdaLN-zero: Linear(SiLU(t)) gives shift, scale and gate of
                  the attention and of the FFN; LayerNorms without affine,
                  eps 1e-6; attention with rotary embedding on q and k over
                  the first head's channels (``F5TTS_Base``'s
                  ``pe_attn_head`` 1: x_transformers' rotary over the packed
                  heads; base 10000, pairs interleaved), bidirectional under
                  a key-padding mask; FFN ``FF_MULT`` x wide with
                  tanh-approximated GELU.
  output          AdaLN-zero final (scale, shift), then Linear to the mels.

Batching: a DiT pass runs on its sequences packed back to back along one
token axis (``Packing``), so its products and elementwise work cover the
rows' own frames and no padding: attention runs a row at a time on views
of the packed projections (both CFG halves of a row in one launch), and
the two position convs run on the padded layout, zero past each row.  The
text embedding (once a call) is padded and masked: its convolutions see
zeros past each row, and GRN's norms over time cover the row's positions
only.  So a row gives in a batch what it gives alone.  F5's own code
masks none of these (its inference runs one row at a time).

Compute runs in ``hp.use_bfloat16`` ? bf16 : fp32 (``dtype``) with fp32
parameters; LayerNorm statistics, GRN and RoPE math are fp32, the
modulation is one fused multiply-add in the compute dtype
(``torch.addcmul``, fp32 inside), and attention goes through
``ops.mha.mha_forward`` (its kernel on a card: fp32 softmax).  The time
path (``time_modulation``) and the text path (``embed_text``) do not
depend on x_t, so the sampler runs them once a call.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..config import Config
from ..ops import mha as mha_ops
from ..utils.device import resolve_device
from .attention import Linear

TEXT_IDS = 256 + 1      # UTF-8 bytes and the filler (row 0)
TIME_FREQ_DIM = 256
LN_EPS = 1e-6
FF_MULT = 2             # DiT FFN width over dit_dim
TEXT_CONV_MULT = 2      # ConvNeXt-V2 hidden width over text_dim
CONV_POS_KERNEL = 31
CONV_POS_GROUPS = 16


def _ln(x: torch.Tensor, weight=None, bias=None) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (eps 1e-6), result in fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, LN_EPS)


def _ln_as(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine over the last axis (eps 1e-6), statistics
    in fp32, in x's dtype."""
    return F.layer_norm(x, (x.shape[-1],), None, None, LN_EPS)


def row_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B] -> [B, t] bool, True inside each row."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def text_position(t: int, dim: int, device) -> torch.Tensor:
    """[t, dim] fp32 [cos | sin] position signal of the text (F5's
    ``precompute_freqs_cis``, base 10000)."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device)
                               [:dim // 2].float() / dim))
    ang = torch.outer(torch.arange(t, device=device).float(), freqs)
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def time_sinusoid(t: torch.Tensor, dim: int = TIME_FREQ_DIM,
                  scale: float = 1000.0) -> torch.Tensor:
    """[S] flow times -> [S, dim] fp32 [sin | cos] embedding of scale x t."""
    half = dim // 2
    step = math.log(10000) / (half - 1)
    freqs = torch.exp(torch.arange(half, device=t.device).float() * -step)
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([ang.sin(), ang.cos()], -1)


def rope_tables(t: int, head_dim: int, device) -> torch.Tensor:
    """[t, head_dim // 2] complex64 turns of the rotary embedding, base
    10000: pair i of a head turns by position x 10000^(-2i / head_dim)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, head_dim, 2, device=device)
                             .float() / head_dim))
    ang = torch.outer(torch.arange(t, device=device).float(), inv)
    return torch.polar(torch.ones_like(ang), ang)


def apply_rope(x: torch.Tensor, turns: torch.Tensor) -> torch.Tensor:
    """x [..., H*D] (a fresh projection, written in place) with the first
    head's channels in interleaved pairs (2i, 2i+1) turned by the pair's
    angle, as one complex product in fp32; ``turns`` [..., D // 2]
    (``rope_tables`` at each position) broadcasts over x's leading axes."""
    lead = x.shape[:-1]
    d = 2 * turns.shape[-1]
    z = torch.view_as_complex(x[..., :d].float().reshape(*lead, d // 2, 2))
    x[..., :d] = torch.view_as_real(z * turns).reshape(*lead, d)
    return x


class Packing:
    """The tokens of one DiT pass: ``halves`` copies of a call's rows (the
    CFG halves), each copy the rows' frames back to back, so that frame p of
    row i in half h is token h R + s_i + p (R the rows' frames, s_i the
    frames before row i).  ``index`` maps the tokens into the padded layout
    [halves B, t] (row i of half h at h B + i) on which the convolutions
    run; ``mask`` is that layout's [halves B, t] rows; ``turns`` the rotary
    turns [halves R, head_dim // 2] of each token's frame."""

    def __init__(self, lengths: Sequence[int], halves: int, t: int,
                 head_dim: int, device):
        self.lengths = [int(n) for n in lengths]
        self.halves, self.t = halves, t
        b = len(self.lengths)
        starts = np.concatenate([[0], np.cumsum(self.lengths)])
        self.starts = [int(s) for s in starts[:-1]]
        self.frames = int(starts[-1])
        pos = np.concatenate([np.arange(n) for n in self.lengths])
        row = np.repeat(np.arange(b), self.lengths)
        index = np.concatenate([(h * b + row) * t + pos
                                for h in range(halves)])
        self.index = torch.from_numpy(index).to(device)
        self.mask = row_mask(torch.tensor(self.lengths * halves,
                                          device=device), t)
        self.turns = rope_tables(t, head_dim, device)[
            torch.from_numpy(np.tile(pos, halves)).to(device)]

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """[k B, t, ...] padded (k = 1: the first half's rows only) -> the
        tokens [k R, ...]."""
        k = x.shape[0] // len(self.lengths)
        return x.reshape(-1, *x.shape[2:]).index_select(
            0, self.index[:k * self.frames])

    def unpack(self, y: torch.Tensor) -> torch.Tensor:
        """The tokens [k R, ...] -> [k B, t, ...] padded, zero past each
        row."""
        k = y.shape[0] // self.frames
        b = k * len(self.lengths)
        out = y.new_zeros((b * self.t,) + tuple(y.shape[1:]))
        out.index_copy_(0, self.index[:y.shape[0]], y)
        return out.view(b, self.t, *y.shape[1:])

    def attend(self, q, k, v, heads: int) -> torch.Tensor:
        """Bidirectional attention of each row over its own frames: q, k, v
        [halves R, H*D] -> [halves R, H*D], one ``mha_forward`` a row over
        its halves (views of the packed projections, no copies)."""
        r, c = self.frames, q.shape[-1]
        scale = (c // heads) ** -0.5
        outs = []
        for s, n in zip(self.starts, self.lengths):
            o, _ = mha_ops.mha_forward(
                *(a.view(self.halves, r, c)[:, s:s + n] for a in (q, k, v)),
                None, heads, False, scale, False)
            outs.append(o)
        return torch.cat(outs, 1).view(self.halves * r, c)


class Conv1d(nn.Conv1d):
    """Conv1d over [B, T, C] with SAME padding, computing in the input's
    dtype; positions outside ``mask`` are zeroed before the convolution."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is not None:
            x = x.masked_fill(~mask[..., None], 0.0)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), bias,
                     padding=self.padding, groups=self.groups)
        return y.transpose(1, 2)


class GRN(nn.Module):
    """ConvNeXt-V2 global response norm over time, within each row's
    ``mask``: gamma * (x * N(x)) + beta + x, N(x) = ||x||_t / (mean over
    channels of ||x||_t + 1e-6).  Parameters are [1, 1, C] as in F5."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x32 = x.float().masked_fill(~mask[..., None], 0.0)
        gx = torch.sqrt(torch.sum(x32 * x32, dim=1, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (x32 * nx) + self.beta + x32).to(x.dtype)


class ConvNeXtV2Block(nn.Module):

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = Linear(dim, hidden)
        self.grn = GRN(hidden)
        self.pwconv2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x, mask)
        h = _ln(h, self.norm.weight, self.norm.bias).to(x.dtype)
        h = F.gelu(self.pwconv1(h))
        h = self.grn(h, mask)
        return x + self.pwconv2(h)


class TextEmbedding(nn.Module):

    def __init__(self, hp: Config, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.text_embed = nn.Embedding(TEXT_IDS, hp.text_dim)
        self.text_blocks = nn.ModuleList(
            ConvNeXtV2Block(hp.text_dim, hp.text_dim * TEXT_CONV_MULT)
            for _ in range(hp.text_conv_layers))

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor, t: int,
                drop_text: bool = False) -> torch.Tensor:
        """ids [B, L] bytes (-1 past the text) -> [B, t, text_dim]: the
        text cut or filled to t positions, zero past each row's
        ``lengths``."""
        ids = (ids[:, :t].long() + 1).clamp_min(0)
        ids = F.pad(ids, (0, t - ids.shape[1]), value=0)
        if drop_text:
            ids = torch.zeros_like(ids)
        mask = row_mask(lengths, t)
        x = F.embedding(ids, self.text_embed.weight).float() + \
            text_position(t, self.text_embed.weight.shape[1], ids.device)
        x = x.masked_fill(~mask[..., None], 0.0).to(self.dtype)
        for block in self.text_blocks:
            x = block(x, mask).masked_fill(~mask[..., None], 0.0)
        return x


class ConvPositionEmbedding(nn.Module):

    def __init__(self, dim: int, kernel: int, groups: int):
        super().__init__()
        self.conv1d = nn.ModuleList([
            Conv1d(dim, dim, kernel, padding=kernel // 2, groups=groups),
            nn.Mish(),
            Conv1d(dim, dim, kernel, padding=kernel // 2, groups=groups),
            nn.Mish()])

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        conv1, _, conv2, _ = self.conv1d
        x = F.mish(conv1(x, mask))
        return F.mish(conv2(x, mask)).masked_fill(~mask[..., None], 0.0)


class InputEmbedding(nn.Module):

    def __init__(self, hp: Config):
        super().__init__()
        self.proj = Linear(hp.num_mels * 2 + hp.text_dim, hp.dit_dim)
        self.conv_pos_embed = ConvPositionEmbedding(
            hp.dit_dim, CONV_POS_KERNEL, CONV_POS_GROUPS)

    def forward(self, x, cond, text, packing: Packing):
        """Tokens [M, ...] -> [M, dim]; the convs on the padded layout."""
        x = self.proj(torch.cat([x, cond, text], -1))
        return packing.pack(self.conv_pos_embed(packing.unpack(x),
                                                packing.mask)) + x


class TimestepEmbedding(nn.Module):

    def __init__(self, dim: int):
        super().__init__()
        self.time_mlp = nn.ModuleList([Linear(TIME_FREQ_DIM, dim), nn.SiLU(),
                                       Linear(dim, dim)])

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        first, _, second = self.time_mlp
        return second(F.silu(first(time_sinusoid(t).to(dtype))))


class _AdaLinear(nn.Module):
    """AdaLN's Linear(SiLU(t)) (F5's ``attn_norm.linear`` /
    ``norm_out.linear``)."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        self.linear = Linear(dim, dim * n)


class Attention(nn.Module):

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim)
        self.to_k = Linear(dim, dim)
        self.to_v = Linear(dim, dim)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, packing: Packing):
        q = apply_rope(self.to_q(x), packing.turns)
        k = apply_rope(self.to_k(x), packing.turns)
        v = self.to_v(x)
        return self.to_out[0](packing.attend(q, k, v, self.heads))


class FeedForward(nn.Module):

    def __init__(self, dim: int):
        super().__init__()
        hidden = dim * FF_MULT
        self.ff = nn.ModuleList([nn.ModuleList([Linear(dim, hidden)]),
                                 nn.Identity(), Linear(hidden, dim)])

    def forward(self, x):
        h = F.gelu(self.ff[0][0](x), approximate="tanh")
        return self.ff[2](h)


class DiTBlock(nn.Module):

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attn_norm = _AdaLinear(dim, 6)
        self.attn = Attention(dim, heads)
        self.ff = FeedForward(dim)

    def forward(self, x, mod, packing: Packing):
        """x [M, dim] tokens; mod [6, 1, dim] in x's dtype: shift, 1 + scale
        and gate of the attention, then of the FFN (F5's chunk order,
        ``time_modulation``)."""
        shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = mod
        h = torch.addcmul(shift_a, _ln_as(x), scale_a)
        x = torch.addcmul(x, gate_a, self.attn(h, packing))
        h = torch.addcmul(shift_f, _ln_as(x), scale_f)
        return torch.addcmul(x, gate_f, self.ff(h))


class F5TTS(nn.Module):
    """The F5-TTS DiT on ``device`` ("cuda" unless the caller asks for the
    CPU; a missing card raises)."""

    def __init__(self, hp: Config, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.hp = hp
        self.dtype = torch.bfloat16 if hp.use_bfloat16 else torch.float32
        dim = hp.dit_dim
        self.time_embed = TimestepEmbedding(dim)
        self.text_embed = TextEmbedding(hp, self.dtype)
        self.input_embed = InputEmbedding(hp)
        self.transformer_blocks = nn.ModuleList(
            DiTBlock(dim, hp.dit_heads)
            for _ in range(hp.dit_depth))
        self.norm_out = _AdaLinear(dim, 2)
        self.proj_out = Linear(dim, hp.num_mels)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.proj_out.weight.device

    def embed_text(self, ids, lengths, t: int, drop_text: bool = False):
        return self.text_embed(ids, lengths, t, drop_text)

    def time_modulation(self, times: torch.Tensor) -> List[torch.Tensor]:
        """[S] flow times -> the modulation of every block, [S, 6, dim]
        each (shift, 1 + scale, gate of the attention, then of the FFN),
        then the final layer's [S, 2, dim] (1 + scale, shift); the 1 added
        in fp32, the result in the compute dtype."""
        temb = F.silu(self.time_embed(times, self.dtype))
        s, dim = times.shape[0], self.hp.dit_dim
        plus = torch.zeros(6, 1, device=times.device)
        plus[[1, 4]] = 1.0
        out = [(blk.attn_norm.linear(temb).float().reshape(s, 6, dim) + plus)
               .to(self.dtype) for blk in self.transformer_blocks]
        out.append((self.norm_out.linear(temb).float().reshape(s, 2, dim) +
                     plus[:2].flip(0)).to(self.dtype))
        return out

    def packing(self, lengths: Sequence[int], halves: int,
                t: int) -> Packing:
        """The ``Packing`` of rows of ``lengths`` frames in a pass."""
        return Packing(lengths, halves, t,
                       self.hp.dit_dim // self.hp.dit_heads, self.device)

    def velocity_packed(self, x, cond, text, packing: Packing, mods):
        """One DiT pass over a packing's tokens: x, cond [M, mels]; text
        [M, text_dim] (``embed_text``, packed); ``mods`` one step's
        modulation (each entry of ``time_modulation`` at that step: [6, dim]
        ... [2, dim]).  Returns the velocity [M, mels] fp32."""
        h = self.input_embed(x.to(self.dtype), cond.to(self.dtype), text,
                             packing)
        for blk, mod in zip(self.transformer_blocks, mods):
            h = blk(h, mod[:, None, :], packing)
        scale, shift = mods[-1][:, None, :]
        return self.proj_out(torch.addcmul(shift, _ln_as(h), scale)).float()

    def velocity(self, x, cond, text, lengths, mods):
        """``velocity_packed`` on padded rows: x, cond [B, T, mels]; text
        [B, T, text_dim]; lengths [B].  Returns the velocity [B, T, mels]
        fp32 (zero past each length)."""
        p = self.packing(lengths.tolist(), 1, x.shape[1])
        return p.unpack(self.velocity_packed(p.pack(x), p.pack(cond),
                                             p.pack(text), p, mods))

    def forward(self, x, cond, ids, time, lengths,
                drop_audio_cond: bool = False, drop_text: bool = False):
        """The velocity at flow time ``time`` (a float) of x [B, T, mels]
        given the prompt mel ``cond`` [B, T, mels] (zero past the prompt),
        the text ids [B, L] and the rows' lengths [B]; F5's
        ``DiT.forward``."""
        t = x.shape[1]
        if drop_audio_cond:
            cond = torch.zeros_like(cond)
        text = self.embed_text(ids, lengths, t, drop_text)
        mods = self.time_modulation(
            torch.full((1,), float(time), device=x.device))
        return self.velocity(x, cond, text, lengths, [m[0] for m in mods])
