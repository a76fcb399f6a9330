"""Plain reference of F5-TTS Base (arXiv:2410.06885, "F5-TTS: A Fairytaler
that Fakes Fluent and Faithful Speech with Flow Matching"; the
``F5TTS_Base`` model config of github.com/SWivid/F5-TTS): its parameters,
random weights from the seed, the DiT's velocity, the sway schedule, the
classifier-free-guided Euler sampler and the duration rule.

Plain PyTorch in float32 (TF32 off: ``no_tf32``), one row at a time, with
no kernels, caches or batching tricks, written from the paper and the
published config.  It imports nothing of the program under test.
Parameters live in a flat dict under F5's state-dict names less its
``transformer.`` prefix, which is also what the program's model loads.

Model:
  text      ids are UTF-8 bytes; id + 1 indexes a 257-row table whose row
            0 is the filler that pads the text to the row's frames (the
            text is cut there if longer); a [cos | sin] position signal,
            base 10000 (angles in float32, as F5 computes them, here and
            in the time and rotary embeddings); ``text_conv_layers``
            ConvNeXt-V2 blocks (depthwise conv k=7, LayerNorm, Linear to
            2x, exact GELU, GRN over time, Linear back, residual)
  input     [x ; prompt mel ; text] -> Linear to ``dit_dim``, plus two
            grouped SAME convs (k=31, 16 groups) each followed by Mish, as
            a residual
  time      [sin | cos] of 1000 t over 128 frequencies 10000^(-k/127) ->
            Linear, SiLU, Linear
  blocks    ``dit_depth`` x: (shift, scale, gate) x 2 = Linear(SiLU(t));
            x += gate1 Attn(RoPE(LN(x) (1 + scale1) + shift1)); x += gate2
            FFN(LN(x) (1 + scale2) + shift2); LayerNorms without affine,
            eps 1e-6; attention bidirectional, 16 heads of 64, q and k
            of the first head rotated by RoPE over its 64 channels (pairs
            (2i, 2i+1), base 10000; ``F5TTS_Base``'s ``pe_attn_head`` 1,
            x_transformers' rotary over the packed heads), softmax in
            float32, scale 64^-0.5; FFN 2x wide, tanh GELU
  output    LN(x) (1 + scale) + shift with (scale, shift) =
            Linear(SiLU(t)); Linear to the mels
Sampler: times i / nfe, i = 0..nfe, swayed t + s (cos(pi t / 2) - 1 + t);
Euler x_{i+1} = x_i + (t_{i+1} - t_i) v_i with v = v_c + w (v_c - v_u),
the unconditional pass with the prompt mel zeroed and every text id the
filler; x_0 unit noise over the row's frames; the prompt's frames of the
result are the prompt mel.  Duration: prompt frames + floor(prompt frames /
prompt bytes x target bytes), at least one frame past the longer of the
prompt and the text (F5's ``CFM.sample``), at most a frame cap.

Departures, each chosen for the check and named here:
  - Weights are random from the seed, and none is zero-initialised: F5
    trains from zero AdaLN modulation and output layers and zero GRN
    parameters, with which every block, the output and every GRN would be
    the identity or zero and the check vacuous.  Linear and conv weights
    and biases are PyTorch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (F5's own for its other layers), the AdaLN and output layers
    included; GRN's gamma and beta U(-0.5, 0.5); the text table N(0, 1);
    LayerNorm affines one and zero.
  - A row runs alone, at its own length; the program's padded batches
    must give the same (the program masks past each row's length).
  - Text ids are the UTF-8 bytes and a filler (257 rows), where F5's
    table is its dataset's vocabulary.

Products go through ``Q`` (``model.exact`` or ``model.fp8``, the control),
applied to both operands of every matrix product and convolution.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from .model import exact

TEXT_IDS = 257
TIME_FREQ_DIM = 256
EPS = 1e-6
# F5TTS_Base's fixed constants
FF_MULT = 2
TEXT_CONV_MULT = 2
CONV_POS_KERNEL = 31
CONV_POS_GROUPS = 16
CFG_STRENGTH = 2.0
SWAY = -1.0


@contextlib.contextmanager
def no_tf32():
    """Float32 products and convolutions without TF32 within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_spec(hp) -> list:
    """[(name, shape, init)]: init "uniform:<fan_in>" (U(+-1/sqrt(fan_in))),
    "grn" (U(-0.5, 0.5)), "normal", "ones", "zeros"."""
    spec = []

    def linear(name, n_in, n_out):
        spec.append((name + ".weight", (n_out, n_in), "uniform:%d" % n_in))
        spec.append((name + ".bias", (n_out,), "uniform:%d" % n_in))

    def conv(name, c, k, groups):
        fan = c // groups * k
        spec.append((name + ".weight", (c, c // groups, k),
                     "uniform:%d" % fan))
        spec.append((name + ".bias", (c,), "uniform:%d" % fan))

    dim, td, m = hp.dit_dim, hp.text_dim, hp.num_mels
    linear("time_embed.time_mlp.0", TIME_FREQ_DIM, dim)
    linear("time_embed.time_mlp.2", dim, dim)
    spec.append(("text_embed.text_embed.weight", (TEXT_IDS, td), "normal"))
    for i in range(hp.text_conv_layers):
        p = "text_embed.text_blocks.%d." % i
        hidden = td * TEXT_CONV_MULT
        conv(p + "dwconv", td, 7, td)
        spec.append((p + "norm.weight", (td,), "ones"))
        spec.append((p + "norm.bias", (td,), "zeros"))
        linear(p + "pwconv1", td, hidden)
        spec.append((p + "grn.gamma", (1, 1, hidden), "grn"))
        spec.append((p + "grn.beta", (1, 1, hidden), "grn"))
        linear(p + "pwconv2", hidden, td)
    linear("input_embed.proj", 2 * m + td, dim)
    for j in (0, 2):
        conv("input_embed.conv_pos_embed.conv1d.%d" % j, dim,
             CONV_POS_KERNEL, CONV_POS_GROUPS)
    for i in range(hp.dit_depth):
        p = "transformer_blocks.%d." % i
        linear(p + "attn_norm.linear", dim, 6 * dim)
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            linear(p + "attn." + name, dim, dim)
        linear(p + "ff.ff.0.0", dim, dim * FF_MULT)
        linear(p + "ff.ff.2", dim * FF_MULT, dim)
    linear("norm_out.linear", dim, 2 * dim)
    linear("proj_out", dim, m)
    return spec


def make_weights(hp, seed: int, device) -> dict:
    """{name: float32 tensor} from the seed, on ``device``: one uniform and
    one normal draw of the whole model from the run's generator
    (``weights.generator(seed, 1)``)."""
    from ..weights import generator
    spec = param_spec(hp)
    gen = generator(seed, 1, device)
    n_uniform = sum(int(np.prod(s)) for _, s, k in spec
                    if k.startswith("uniform") or k == "grn")
    n_normal = sum(int(np.prod(s)) for _, s, k in spec if k == "normal")
    uni = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_normal, generator=gen, device=device)
    out, at_u, at_n = {}, 0, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        if kind.startswith("uniform") or kind == "grn":
            bound = 0.5 if kind == "grn" else \
                1.0 / math.sqrt(int(kind.split(":")[1]))
            t = uni[at_u:at_u + n] * bound
            at_u += n
        elif kind == "normal":
            t = nor[at_n:at_n + n]
            at_n += n
        else:
            t = torch.full((n,), 1.0 if kind == "ones" else 0.0,
                           device=device)
        out[name] = t.reshape(shape).clone()
    return out


# ---------------------------------------------------------------------------
# the DiT, one row
# ---------------------------------------------------------------------------

def _linear(P, name, x, Q):
    return Q(x) @ Q(P[name + ".weight"]).t() + P[name + ".bias"]


def _conv(P, name, x, groups, Q):
    """x [T, C] -> [T, C], SAME zero padding."""
    w = P[name + ".weight"]
    y = F.conv1d(Q(x).t()[None], Q(w), P[name + ".bias"],
                 padding=w.shape[-1] // 2, groups=groups)
    return y[0].t()


def _layer_norm(x, weight=None, bias=None):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + EPS)
    if weight is not None:
        y = y * weight + bias
    return y


def text_embedding(P, hp, ids, t: int, drop: bool, Q=exact):
    """ids [L] bytes -> [t, text_dim]."""
    ids = [int(i) + 1 for i in ids[:t]] + [0] * max(0, t - len(ids))
    if drop:
        ids = [0] * t
    x = P["text_embed.text_embed.weight"][torch.tensor(
        ids, device=P["proj_out.weight"].device)]
    dim = x.shape[1]
    k = torch.arange(0, dim, 2, device=x.device)[:dim // 2].float()
    ang = torch.arange(t, device=x.device).float()[:, None] * \
        (1.0 / 10000.0 ** (k / dim))[None, :]
    x = x + torch.cat([torch.cos(ang), torch.sin(ang)], -1)
    for i in range(hp.text_conv_layers):
        p = "text_embed.text_blocks.%d." % i
        h = _conv(P, p + "dwconv", x, dim, Q)
        h = _layer_norm(h, P[p + "norm.weight"], P[p + "norm.bias"])
        h = F.gelu(_linear(P, p + "pwconv1", h, Q))
        g = torch.linalg.vector_norm(h, dim=0, keepdim=True)
        n = g / (g.mean(-1, keepdim=True) + 1e-6)
        h = P[p + "grn.gamma"][0] * (h * n) + P[p + "grn.beta"][0] + h
        x = x + _linear(P, p + "pwconv2", h, Q)
    return x


def time_embedding(P, t: float, Q=exact):
    """[dim] of flow time t."""
    half = TIME_FREQ_DIM // 2
    dev = P["proj_out.weight"].device
    freqs = torch.exp(torch.arange(half, device=dev).float() *
                      -(math.log(10000.0) / (half - 1)))
    ang = 1000.0 * torch.tensor(t, device=dev, dtype=torch.float32) * freqs
    e = torch.cat([torch.sin(ang), torch.cos(ang)])[None]
    h = F.silu(_linear(P, "time_embed.time_mlp.0", e, Q))
    return _linear(P, "time_embed.time_mlp.2", h, Q)[0]


def _rope(x, d: int):
    """x [T, H*D]: the first d channels' pairs (2i, 2i+1) turned by
    position x 10000^(-2i / d), as complex products; the rest as they
    are."""
    t = x.shape[0]
    inv = 1.0 / 10000.0 ** (torch.arange(0, d, 2, device=x.device).float()
                            / d)
    ang = torch.arange(t, device=x.device).float()[:, None] * inv[None, :]
    turn = torch.polar(torch.ones_like(ang), ang)
    z = torch.view_as_complex(x[:, :d].reshape(t, d // 2, 2).contiguous())
    return torch.cat([torch.view_as_real(z * turn).reshape(t, d), x[:, d:]],
                     -1)


def _attention(P, p, x, heads, Q):
    t, c = x.shape
    d = c // heads
    q = _rope(_linear(P, p + "to_q", x, Q), d)
    k = _rope(_linear(P, p + "to_k", x, Q), d)
    v = _linear(P, p + "to_v", x, Q)
    q, k, v = (a.reshape(t, heads, d).transpose(0, 1) for a in (q, k, v))
    w = torch.softmax(Q(q) @ Q(k).transpose(1, 2) * d ** -0.5, dim=-1)
    o = (Q(w) @ Q(v)).transpose(0, 1).reshape(t, c)
    return _linear(P, p + "to_out.0", o, Q)


def velocity(P, hp, x, cond, ids, t: float, drop: bool, Q=exact):
    """The DiT's velocity [T, mels] of one row: x, cond [T, mels] (cond zero
    past the prompt), ids [L] bytes; ``drop`` the unconditional pass."""
    n = x.shape[0]
    if drop:
        cond = torch.zeros_like(cond)
    text = text_embedding(P, hp, ids, n, drop, Q)
    h = _linear(P, "input_embed.proj", torch.cat([x, cond, text], -1), Q)
    r = h
    for j in (0, 2):
        r = F.mish(_conv(P, "input_embed.conv_pos_embed.conv1d.%d" % j, r,
                         CONV_POS_GROUPS, Q))
    h = h + r
    temb = F.silu(time_embedding(P, t, Q))[None]
    dim = hp.dit_dim
    for i in range(hp.dit_depth):
        p = "transformer_blocks.%d." % i
        mod = _linear(P, p + "attn_norm.linear", temb, Q)[0]
        sa, ca, ga, sf, cf, gf = (mod[j * dim:(j + 1) * dim]
                                  for j in range(6))
        a = _layer_norm(h) * (1 + ca) + sa
        h = h + ga * _attention(P, p + "attn.", a, hp.dit_heads, Q)
        f = _layer_norm(h) * (1 + cf) + sf
        f = F.gelu(_linear(P, p + "ff.ff.0.0", f, Q), approximate="tanh")
        h = h + gf * _linear(P, p + "ff.ff.2", f, Q)
    mod = _linear(P, "norm_out.linear", temb, Q)[0]
    h = _layer_norm(h) * (1 + mod[:dim]) + mod[dim:]
    return _linear(P, "proj_out", h, Q)


def cfg_velocity(P, hp, x, cond, ids, t: float, Q=exact):
    v_c = velocity(P, hp, x, cond, ids, t, False, Q)
    v_u = velocity(P, hp, x, cond, ids, t, True, Q)
    return v_c + CFG_STRENGTH * (v_c - v_u)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

def flow_times(nfe: int, sway: float) -> list:
    """nfe + 1 swayed flow times (float32 values, as F5's)."""
    out = []
    for i in range(nfe + 1):
        t = float(np.float32(i / nfe))
        out.append(float(np.float32(t + sway * (math.cos(math.pi / 2 * t)
                                                 - 1 + t))))
    return out


def duration(prompt_frames: int, prompt_bytes: int, target_bytes: int,
             text_bytes: int, cap: int) -> int:
    """A row's total frames (F5's ``infer_process`` and ``CFM.sample``)."""
    n = prompt_frames + math.floor(prompt_frames / prompt_bytes *
                                   target_bytes)
    return min(max(n, max(prompt_frames, text_bytes) + 1), cap)


def prompt_cond(prompt, t: int):
    """[t, mels]: the prompt mel, zero past it."""
    cond = torch.zeros((t, prompt.shape[1]), device=prompt.device)
    cond[:prompt.shape[0]] = prompt
    return cond


@torch.no_grad()
def sample(P, hp, x0, prompt, ids, Q=exact, keep=()):
    """One row: x0 [T, mels] the noise over its frames, prompt [n, mels],
    ids [L] bytes.  Returns (mel [T, mels] with the prompt's frames the
    prompt, {i: (x_i, v_i), the state and guided velocity of step i, for
    i in ``keep``})."""
    times = flow_times(hp.flow_nfe, SWAY)
    n = prompt.shape[0]
    cond = prompt_cond(prompt, x0.shape[0])
    x, states = x0.clone(), {}
    for i in range(hp.flow_nfe):
        v = cfg_velocity(P, hp, x, cond, ids, times[i], Q)
        if i in keep:
            states[i] = (x.clone(), v)
        x = x + (times[i + 1] - times[i]) * v
    x[:n] = prompt
    return x, states
