"""Fused AR decode step: one frame through every decoder layer in one call.

Counterpart of ``few_shot_transformer_tts_tpu/ops/pallas_decode.py``, with
its layouts at the public functions: stacked weights ``[L, in, out]``, packed
heads ``[.., C = H*D]`` in the self-attention caches ``[L, B, Tcap, C]`` and
the encoder memory ``[L, B, Tm, C]``, cross-attention weights ``[L, B, Tm,
H]``.

``decoder_frame_step`` launches ``csrc/decoder_step.cu`` (one cooperative
kernel per frame) for CUDA tensors and takes ``decoder_frame_step_plain``,
the same math in plain PyTorch, for CPU tensors.  The plain version is also
what the tests and ``chip_smoke.py`` hold the kernel against.  The kernel
reads its weights pre-tiled (``pack_decoder_weights``, which
``stack_decoder_params`` calls once per synthesis: ``w["tiles"]``) and splits
them over the card's SMs by ``decoder_schedule``.  It is deterministic:
every sum runs in a fixed order (no float atomics), so the same inputs give
the same bits.

Per layer: LN -> fused QKV -> causal self-attention over the cached prefix
(positions < step) jointly with this frame's fresh k/v -> out-proj +
residual -> LN -> q-proj -> cross-attention over the memory with its
additive padding bias -> out-proj + residual -> LN -> ReLU FFN + residual.
The residual stream is fp32 across layers; LN statistics are fp32 (two-pass,
eps 1e-6).  Rounding points of the TPU kernel, kept by both versions:
products take inputs rounded to the weights' type and accumulate in fp32;
each cached logit term ``q_d * k_d`` is rounded to the cache type before the
fp32 head sum, and so is each term of the fresh logit ``q_d * k_new_d``;
softmax weights are rounded to the weights' type before they multiply v
(fp32); k_new/v_new take the cache type.  In an fp32 model all of these are
the identity.
"""

from __future__ import annotations

import ctypes
import functools
import heapq

import numpy as np
import torch

from . import cuda_build
from ..utils import tracing

_TB = 256                   # cache / memory length multiple (the TPU's block)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WEIGHTS = ("w_qkv", "w_out", "w_q", "w_xout", "w_ffn1", "w_ffn2")
_SLOT_BYTES = 16384         # one ring slot of the kernel (csrc kSlotBytes)
# a head's row is 16 bytes per consumer thread of the kernel at most
# (csrc kConsumers): D <= 2048 in bf16, 1024 in fp32
_MAX_HEAD_BYTES = 4096
_UNIT_COST = 4096           # a unit's fixed cost in the schedule, in bytes
# The kernel's stages in each layer, in the order of its timeline: the
# stamps are the start, the end of the set-up, then the end of each of
# these per layer.
STAGES = ("qkv", "self_attention", "out_proj", "q_proj", "cross_attention",
          "cross_out_proj", "ffn_in", "ffn_out")


def _rup(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_cap(max_frames: int) -> int:
    """The self-attention cache length for ``max_frames`` frames."""
    return _rup(max(max_frames, 1), _TB)


def stack_decoder_params(decoder, dtype: torch.dtype) -> dict:
    """The decoder's per-layer weights stacked over a leading layer axis.

    ``decoder`` is the port's ``TransformerDecoder``.  Linear weights are
    transposed to [in, out] and cast to ``dtype``: ``w_qkv`` [L, C, 3C],
    ``w_out``/``w_q``/``w_xout`` [L, C, C], ``w_ffn1`` [L, C, 4C], ``w_ffn2``
    [L, 4C, C]; ``lns`` [L, 6, C] fp32 holds the (scale, bias) pairs of the
    self-attention, cross-attention and FFN LayerNorms.  ``w_kv`` [L, C_mem,
    2C] is for ``project_memory``, not for the kernel.  ``tiles`` is the
    kernel's copy of the six product weights (``pack_decoder_weights``).
    """
    def over(get):
        return torch.stack([get(i).weight.detach().t() for i in
                            range(len(decoder.self_attentions))]).to(dtype)

    lns = torch.stack([torch.stack([
        decoder.attn_layer_norms[i].weight, decoder.attn_layer_norms[i].bias,
        decoder.encdec_layer_norms[i].weight,
        decoder.encdec_layer_norms[i].bias,
        decoder.ffn_layer_norms[i].weight, decoder.ffn_layer_norms[i].bias])
        for i in range(len(decoder.self_attentions))]).detach().float()
    w = {
        "lns": lns,
        "w_qkv": over(lambda i: decoder.self_attentions[i].qkv_transform),
        "w_out": over(lambda i: decoder.self_attentions[i].output_transform),
        "w_q": over(lambda i: decoder.encdec_attentions[i].q_transform),
        "w_kv": over(lambda i: decoder.encdec_attentions[i].kv_transform),
        "w_xout": over(lambda i: decoder.encdec_attentions[i]
                       .output_transform),
        "w_ffn1": over(lambda i: decoder.ffn_layers[i].input_layer),
        "w_ffn2": over(lambda i: decoder.ffn_layers[i].output_layer),
    }
    w["tiles"] = pack_decoder_weights(w)
    return w


def _rup16(x: int) -> int:
    return (x + 15) // 16 * 16


def _stage_shapes(c: int, f: int):
    """(K, N) of the six products of a layer, in the kernel's order."""
    return ((c, 3 * c), (c, c), (c, c), (c, c), (c, f), (f, c))


def layer_elems(c: int, f: int) -> int:
    """Elements of one layer of ``pack_decoder_weights``' layout."""
    return sum(_rup16(k) * _rup16(n) for k, n in _stage_shapes(c, f))


@functools.lru_cache(maxsize=None)
def _fragment_order():
    """(k, n) within a 16 x 16 weight tile of element lane * 8 + e of the
    packed tile: the mma.m16n8k16 A fragment of lane 4g + t, A[m][k] =
    W[k][m] -- registers (k 2t.., n g), (k 2t.., n g+8), (k 2t+8.., n g),
    (k 2t+8.., n g+8), two k each."""
    lane, e = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
    g, t, reg, half = lane // 4, lane % 4, e // 2, e % 2
    k = 2 * t + half + 8 * (reg // 2)
    n = g + 8 * (reg % 2)
    return torch.from_numpy((k * 16 + n).reshape(-1))


def pack_decoder_weights(w: dict) -> torch.Tensor:
    """The kernel's layout of the six product weights: [L, layer_elems] in
    their type.  Per layer, stage by stage (w_qkv, w_out, w_q, w_xout,
    w_ffn1, w_ffn2), each [K, N] matrix zero-padded to multiples of 16 and
    cut into units of 16 output columns; a unit holds its K/16 tiles of
    16 x 16 in k order, each tile in the order of ``_fragment_order`` (one
    16-byte load per lane in bf16)."""
    parts = []
    order = _fragment_order()
    for name in _WEIGHTS:
        m = w[name]
        n_layers, k, n = m.shape
        kp, np_ = _rup16(k), _rup16(n)
        m = torch.nn.functional.pad(m, (0, np_ - n, 0, kp - k))
        tiles = m.reshape(n_layers, kp // 16, 16, np_ // 16, 16).permute(
            0, 3, 1, 2, 4).reshape(n_layers, np_ // 16, kp // 16, 256)
        parts.append(tiles[..., order].reshape(n_layers, -1))
    return torch.cat(parts, 1).contiguous()


def unpack_decoder_weights(tiles: torch.Tensor, c: int, f: int) -> dict:
    """The stacked [L, K, N] matrices back from ``pack_decoder_weights``."""
    n_layers = tiles.shape[0]
    inverse = torch.argsort(_fragment_order())
    out, off = {}, 0
    for name, (k, n) in zip(_WEIGHTS, _stage_shapes(c, f)):
        kp, np_ = _rup16(k), _rup16(n)
        part = tiles[:, off:off + kp * np_].reshape(
            n_layers, np_ // 16, kp // 16, 256)[..., inverse]
        out[name] = part.reshape(n_layers, np_ // 16, kp // 16, 16, 16) \
            .permute(0, 2, 3, 1, 4).reshape(n_layers, kp, np_)[:, :k, :n]
        off += kp * np_
    return out


@functools.lru_cache(maxsize=None)
def decoder_schedule(c: int, f: int, elt: int, grid: int):
    """Which block of a ``grid``-block launch owns which weight unit: int32
    numpy arrays (offsets [grid + 1], entries), block g's entries
    ``entries[offsets[g]:offsets[g + 1]]``, each ``stage << 16 | unit``
    (unit = 16 output columns of the stage's product), sorted by stage and
    unit.  Largest units first (the FFN's second product has 4x the rows),
    each unit goes to the block with the fewest bytes so far (its K x 16
    weights of ``elt`` bytes plus a fixed cost per unit; ties to the lower
    block), so every block streams about the same bytes per layer.  The
    same for every layer."""
    units = [(_rup16(k) * 16 * elt + _UNIT_COST, stage, unit)
             for stage, (k, n) in enumerate(_stage_shapes(c, f))
             for unit in range(_rup16(n) // 16)]
    units.sort(key=lambda u: -u[0])          # stable: stage, unit order
    owned = [[] for _ in range(grid)]
    heap = [(0, g) for g in range(grid)]
    for cost, stage, unit in units:
        load, g = heapq.heappop(heap)
        owned[g].append(stage << 16 | unit)
        heapq.heappush(heap, (load + cost, g))
    owned = [sorted(o) for o in owned]
    offsets = np.cumsum([0] + [len(o) for o in owned]).astype(np.int32)
    entries = np.asarray([e for o in owned for e in o], dtype=np.int32)
    return offsets, entries


def project_memory(enc: torch.Tensor, w_kv: torch.Tensor,
                   dtype: torch.dtype, pad_to: int = _TB):
    """Cross-attention K/V of every layer, packed heads: (mem_k, mem_v), each
    [L, B, TmP, C] in ``dtype`` with the time axis zero-padded to a multiple
    of ``pad_to``.  enc [B, Tm, C_mem]; w_kv [L, C_mem, 2C].  One batched
    product in w_kv's type, outside the kernel (as the JAX package leaves it
    to XLA)."""
    c = w_kv.shape[2] // 2
    kv = torch.matmul(enc.to(w_kv.dtype)[None], w_kv[:, None])  # [L,B,Tm,2C]
    tm = kv.shape[2]
    kv = torch.nn.functional.pad(kv, (0, 0, 0, _rup(max(tm, 1), pad_to) - tm))
    return (kv[..., :c].to(dtype).contiguous(),
            kv[..., c:].to(dtype).contiguous())


def _rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t (fp32) rounded to ``dtype`` and back."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def _ln(x, scale, bias, eps=1e-6):
    m = x.mean(-1, keepdim=True)
    xc = x - m
    v = (xc * xc).mean(-1, keepdim=True)
    return xc * (1.0 / torch.sqrt(v + eps)) * scale + bias


def decoder_frame_step_plain(x, step: int, w, cache_k, cache_v, mem_k, mem_v,
                             mem_bias, *, num_heads: int):
    """Plain PyTorch version of the kernel; arguments and returns as
    ``decoder_frame_step``."""
    n_layers, b, _, c = cache_k.shape
    h = num_heads
    d = c // h
    wdt, cdt = w["w_qkv"].dtype, cache_k.dtype
    scale = float(d) ** -0.5
    mm = lambda a, wt: torch.matmul(_rnd(a, wdt), wt.float())
    heads = lambda t: t.reshape(*t.shape[:-1], h, d)
    x = x.float()
    aligns, k_new, v_new = [], [], []
    for l in range(n_layers):
        lns = w["lns"][l].float()
        # causal self-attention over the cached prefix and the fresh position
        qkv = mm(_ln(x, lns[0], lns[1]), w["w_qkv"][l])
        q, k_f, v_f = qkv[:, :c] * scale, qkv[:, c:2 * c], qkv[:, 2 * c:]
        k_new.append(k_f.to(cdt))
        v_new.append(v_f.to(cdt))
        fresh = _rnd(heads(q * k_f), wdt).sum(-1)                  # [B, H]
        s = _rnd(heads(_rnd(q, cdt))[:, None] *
                 heads(cache_k[l, :, :step].float()), cdt).sum(-1)  # [B,t,H]
        m = torch.maximum(s.amax(1), fresh) if step else fresh
        p = torch.exp(s - m[:, None])
        pf = torch.exp(fresh - m)
        den = p.sum(1) + pf
        ctx = (_rnd(p / den[:, None], wdt)[..., None] *
               heads(cache_v[l, :, :step].float())).sum(1) + \
            _rnd(pf / den, wdt)[..., None] * heads(v_f)
        x = x + mm(ctx.reshape(b, c), w["w_out"][l])
        # cross-attention over the encoder memory
        qx = mm(_ln(x, lns[2], lns[3]), w["w_q"][l]) * scale
        s = _rnd(heads(_rnd(qx, cdt))[:, None] * heads(mem_k[l].float()),
                 cdt).sum(-1) + mem_bias.float()[..., None]        # [B,Tm,H]
        p = torch.exp(s - s.amax(1, keepdim=True))
        wts = p / p.sum(1, keepdim=True)
        aligns.append(wts)
        ctx = (_rnd(wts, wdt)[..., None] * heads(mem_v[l].float())).sum(1)
        x = x + mm(ctx.reshape(b, c), w["w_xout"][l])
        # FFN
        hid = torch.relu(mm(_ln(x, lns[4], lns[5]), w["w_ffn1"][l]))
        x = x + mm(hid, w["w_ffn2"][l])
    return x, torch.stack(aligns), torch.stack(k_new), torch.stack(v_new)


def _check(x, step, w, cache_k, cache_v, mem_k, mem_v, mem_bias, num_heads):
    if cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError("cache_k and cache_v must be one [L, B, Tcap, C] "
                         "shape, got %s %s" % (tuple(cache_k.shape),
                                               tuple(cache_v.shape)))
    n_layers, b, t_cap, c = cache_k.shape
    t_mem = mem_k.shape[2] if mem_k.dim() == 4 else -1
    f = w["w_ffn1"].shape[-1]
    want = {"x": (x, (b, c)), "mem_k": (mem_k, (n_layers, b, t_mem, c)),
            "mem_v": (mem_v, (n_layers, b, t_mem, c)),
            "mem_bias": (mem_bias, (b, t_mem)),
            "lns": (w["lns"], (n_layers, 6, c)),
            "w_qkv": (w["w_qkv"], (n_layers, c, 3 * c)),
            "w_out": (w["w_out"], (n_layers, c, c)),
            "w_q": (w["w_q"], (n_layers, c, c)),
            "w_xout": (w["w_xout"], (n_layers, c, c)),
            "w_ffn1": (w["w_ffn1"], (n_layers, c, f)),
            "w_ffn2": (w["w_ffn2"], (n_layers, f, c))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError("%s must be %s, got %s"
                             % (name, shape, tuple(t.shape)))
    if c % num_heads:
        raise ValueError("C=%d does not divide into %d heads"
                         % (c, num_heads))
    if not 0 <= step < t_cap:
        raise ValueError("step %d is outside the cache of %d positions"
                         % (step, t_cap))


def _check_cuda(x, w, cache_k, cache_v, mem_k, mem_v, mem_bias, num_heads):
    if x.device.type != "cuda":
        raise ValueError("decoder_frame_step runs on CPU or CUDA tensors, "
                         "not %s" % x.device)
    dt = cache_k.dtype
    if "tiles" not in w:
        raise ValueError("the kernel reads w['tiles'] (pack_decoder_weights; "
                         "stack_decoder_params adds it)")
    tensors = [x, cache_k, cache_v, mem_k, mem_v, mem_bias, w["lns"],
               w["tiles"]]
    if dt not in _DTYPE_CODES or any(
            t.dtype != dt for t in [cache_v, mem_k, mem_v, w["tiles"]] +
            [w[n] for n in _WEIGHTS]):
        raise ValueError("the kernel takes float32 or bfloat16 weights, "
                         "caches and memory, all of one type")
    if x.dtype != torch.float32 or mem_bias.dtype != torch.float32 or \
            w["lns"].dtype != torch.float32:
        raise ValueError("x, mem_bias and lns must be float32")
    if any(t.device != x.device for t in tensors):
        raise ValueError("every tensor must lie on x's device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("the kernel takes contiguous, 16-byte aligned "
                         "tensors")
    n_layers, c, f = cache_k.shape[0], x.shape[1], w["w_ffn1"].shape[-1]
    if tuple(w["tiles"].shape) != (n_layers, layer_elems(c, f)):
        raise ValueError("w['tiles'] must be [%d, %d] for C=%d, F=%d, got %s"
                         % (n_layers, layer_elems(c, f), c, f,
                            tuple(w["tiles"].shape)))
    d = c // num_heads
    elt = cache_k.element_size()
    vec = 16 // elt
    if d % vec or f % vec or d * elt > _MAX_HEAD_BYTES:
        raise ValueError(
            "the kernel takes head dims and FFN widths that are multiples of "
            "%d (16 bytes), head dims of at most %d bytes (D <= %d); got "
            "D=%d, F=%d" % (vec, _MAX_HEAD_BYTES, _MAX_HEAD_BYTES // elt, d,
                            f))
    if 2 * c * 4 > _SLOT_BYTES:
        raise ValueError("the kernel streams each LayerNorm's scale and "
                         "bias as one 16 KB slot: C <= %d, got %d"
                         % (_SLOT_BYTES // 8, c))
    if _library().decoder_step_smem_bytes(elt, c, f, d) == 0:
        raise ValueError("C=%d, F=%d: the staged activations leave less "
                         "than two 16 KB ring slots of shared memory"
                         % (c, f))


@functools.lru_cache(maxsize=None)
def _launch_tables(device: torch.device, c: int, f: int, elt: int):
    """(grid, schedule offsets, schedule entries) on ``device``: one block
    per SM."""
    grid = torch.cuda.get_device_properties(device).multi_processor_count
    offsets, entries = decoder_schedule(c, f, elt, grid)
    return (grid, torch.from_numpy(offsets).to(device),
            torch.from_numpy(entries).to(device))


_BARRIERS = {}


def barrier_state(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's grid barrier on ``stream`` (its handle): one int64 count
    of block arrivals, zero when made, that grows by the grid size at every
    grid barrier the launches pass."""
    key = (device, stream)
    if key not in _BARRIERS:
        _BARRIERS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return _BARRIERS[key]


def decoder_frame_step(x, step: int, w, cache_k, cache_v, mem_k, mem_v,
                       mem_bias, *, num_heads: int, trace=None):
    """One frame through all decoder layers.

    x [B, C] fp32 (prenet output + PE, dropout off); ``step`` (int) the
    frame's position; ``w`` from ``stack_decoder_params``; cache_k/v [L, B,
    Tcap, C] with positions < step valid; mem_k/v [L, B, Tm, C]; mem_bias
    [B, Tm] fp32 additive padding bias (-1e20 on padded columns).

    Returns (x_out [B, C] fp32 before the final LN, align [L, B, Tm, H] fp32
    cross-attention weights, k_new [L, B, C], v_new [L, B, C] in the cache
    type); the caller writes k_new/v_new into the caches at ``step``.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  The kernel reads ``w["tiles"]`` and ``w["lns"]``, takes weights,
    caches and memory of one type (fp32 or bf16), head dims whose rows are
    a multiple of 16 bytes (D % 8 == 0 in bf16, D % 4 == 0 in fp32) and at
    most 4 KB (D <= 2048 in bf16, 1024 in fp32), any cache or memory
    length, C <= 2048, and C and F whose staged
    activations leave two ring slots of shared memory.  ``trace``, an int64
    CUDA tensor of len(STAGES) * L + 2 elements, receives the kernel's
    stage timeline.  The kernel is deterministic.  Launches on one stream
    run one after another: they share the grid barrier's state.
    """
    with tracing.span("ops.decoder_frame_step"):
        step = int(step)
        _check(x, step, w, cache_k, cache_v, mem_k, mem_v, mem_bias, num_heads)
        if x.device.type == "cpu":
            return decoder_frame_step_plain(x, step, w, cache_k, cache_v,
                                            mem_k, mem_v, mem_bias,
                                            num_heads=num_heads)
        _check_cuda(x, w, cache_k, cache_v, mem_k, mem_v, mem_bias, num_heads)
        n_layers, b, t_cap, c = cache_k.shape
        if trace is not None and (
                trace.dtype != torch.int64 or trace.device != x.device or
                trace.numel() != len(STAGES) * n_layers + 2 or
                not trace.is_contiguous()):
            raise ValueError("trace must be a contiguous int64 tensor of "
                             "%d L + 2 elements on x's device" % len(STAGES))
        t_mem = mem_k.shape[2]
        f = w["w_ffn1"].shape[-1]
        dev, cdt = x.device, cache_k.dtype
        x_out = torch.empty((b, c), dtype=torch.float32, device=dev)
        align = torch.empty((n_layers, b, t_mem, num_heads),
                            dtype=torch.float32, device=dev)
        k_new = torch.empty((n_layers, b, c), dtype=cdt, device=dev)
        v_new = torch.empty((n_layers, b, c), dtype=cdt, device=dev)
        lib = _library()
        grid, offsets, entries = _launch_tables(dev, c, f,
                                                cache_k.element_size())
        stream = torch.cuda.current_stream(dev).cuda_stream
        # attention logits, chunk statistics and contexts, qkv, cross q, the
        # rounded context and FFN hidden, the exchange counters
        scratch = torch.empty((lib.decoder_step_scratch_bytes(
            cache_k.element_size(), n_layers, b, c, f, num_heads, t_cap, t_mem,
            grid),),
            dtype=torch.uint8, device=dev)
        err = lib.decoder_step(
            _DTYPE_CODES[cdt], x.data_ptr(), step, w["lns"].data_ptr(),
            w["tiles"].data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            mem_k.data_ptr(), mem_v.data_ptr(), mem_bias.data_ptr(),
            x_out.data_ptr(), align.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), scratch.data_ptr(),
            barrier_state(dev, stream).data_ptr(), offsets.data_ptr(),
            entries.data_ptr(), None if trace is None else trace.data_ptr(),
            n_layers, b, t_cap, t_mem, c, f, num_heads, grid, stream)
        if err != 0:
            raise RuntimeError("decoder_step launch failed: %s"
                               % lib.decoder_step_error_string(err).decode())
        decoder_frame_step.launches += 1
        return x_out, align, k_new, v_new


# Kernel launches since the count was last reset (tests and chip_smoke.py
# read it to show that a path went through the kernel).
decoder_frame_step.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("decoder_step")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decoder_step.argtypes = [i, p, i] + [p] * 16 + [i] * 8 + [p]
    lib.decoder_step.restype = i
    lib.decoder_step_scratch_bytes.argtypes = [i] * 9
    lib.decoder_step_scratch_bytes.restype = ll
    lib.decoder_step_smem_bytes.argtypes = [i] * 4
    lib.decoder_step_smem_bytes.restype = ll
    lib.decoder_step_error_string.argtypes = [i]
    lib.decoder_step_error_string.restype = ctypes.c_char_p
    return lib
