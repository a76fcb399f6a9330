"""Multi-head attention forward and backward in the packed [B, T, H*D] layout.

Counterpart of ``mha_train`` (``few_shot_transformer_tts_tpu/ops/
pallas_attention_train.py``): its forward with post-softmax dropout and its
flash backward.  ``mha_forward`` launches ``csrc/mha_fwd.cu`` and
``mha_backward`` launches ``csrc/mha_bwd.cu`` for CUDA tensors; for CPU
tensors each takes its plain version (``mha_forward_plain``,
``mha_backward_plain``), the same math in plain PyTorch.  The plain versions
are also what the tests and ``chip_smoke.py`` hold the kernels against;
nothing on the main path calls them when a card is present.
``MhaFunction`` is the autograd Function over the pair.

Semantics kept from the TPU kernel: q is scaled in fp32 and rounded back to
its type before the dot; scores, the softmax statistics and ``lse = m + log l``
are fp32; causal masking writes -1e20; keys at or beyond Tk are excluded;
dropout masks the unnormalized ``p`` (``l`` sums the unmasked ``p``) and
``1/keep`` folds into the output scale; ``p`` is cast to v's type before the
P.V product; ``o = acc / max(l * keep, 1e-30)`` in q's type.  ``lse`` is
[B, Tq, H].  The backward rounds where the TPU kernel does: do and o in fp32,
``g`` and ``do/keep`` in the input type for dv, one ``ds * scale`` rectangle
in the input type for dq and dk.

The bf16 kernels run their products on the tensor cores and copy rows
with 16-byte ``cp.async``: ``check_alignment`` holds their inputs to
16-byte base addresses and strides, and a CUDA tensor that breaks it
raises.  The fp32 kernels are scalar (TF32 stays off).

Head dims.  The kernels are instantiated for every head dim that is a
multiple of 32 from 32 to 256 (``KERNEL_HEAD_DIMS``), one library per head
dim, built when a run first meets it (``cuda_build``).  Head dims above 256
run on ``csrc/mha_wide.cu``, one library whose kernels take the head dim at
run time (a multiple of 32 up to ``MAX_HEAD_DIM`` = 1024): in bf16 on the
tensor cores, each block owning a slice of at most 256 output columns, and
each score tile computed once and kept, with the backward's two rounded
T x T operands (g and ds * scale), in a workspace that the wrapper
allocates (``wide_workspace``); in fp32 scalar, in 128-wide chunks.  Any
other head dim runs on the next multiple of 32
(``kernel_head_dim``): the wrapper zero-pads each head's channels of q, k,
v (and o, do) and slices the outputs back (``pad_heads``, ``unpad_heads``).
That is exact: zero channels add nothing to q.k and give zero output
columns, and the caller's softmax scale is passed as it is.  A head dim
above 1024 raises ``ValueError``.

The dropout mask is a pure function of (seed, b, h, q, k):
``dropout_keep_mask`` (Philox-4x32-10, the same bits as ``csrc/philox.cuh``).
The seed is an int64 tensor of one element on the tensors' device, so no
call waits on the device to read it.  ``head_offset`` shifts h: a
tensor-parallel rank that holds heads ``[head_offset, head_offset + H)`` of
a layer draws that layer's mask of those heads, so its mask is the slice of
the whole layer's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from ..utils import tracing

NEG_INF = -1e20
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = cuda_build.HEAD_DIMS
MAX_HEAD_DIM = 1024         # csrc/mha_wide.cu above KERNEL_HEAD_DIMS[-1]

# Philox-4x32-10 constants (csrc/philox.cuh)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _split_heads_f32(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2).float()


def _combine_heads(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d).to(dtype)


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run head dim ``d`` at: ``d`` rounded up to
    a multiple of 32 (one of ``KERNEL_HEAD_DIMS`` up to 256, the run-time
    head dim of ``csrc/mha_wide.cu`` above); raises above
    ``MAX_HEAD_DIM``."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError("the attention kernels take head dims 1 to %d, "
                         "got %d" % (MAX_HEAD_DIM, d))
    return -(-d // 32) * 32


def wide_workspace(direction: str, batch: int, num_heads: int, tq: int,
                   tk: int):
    """(shape, dtype) of the workspace that ``csrc/mha_wide.cu`` takes in
    bf16 (head dims above 256), Tq and Tk rounded up to its 64-row tiles
    (Tq64, Tk64).  "forward": fp32 [B, H, Tq64, Tk64 + 3 * Tk64 / 64],
    each 64 x 64 score tile once, then each tile's row maxima, then its
    dropout mask (128 words); "backward": bf16 [2, B, H, Tq64, Tk64],
    round(g), then round(ds * scale)."""
    tq64, tk64 = -(-tq // 64) * 64, -(-tk // 64) * 64
    if direction == "forward":
        return (batch, num_heads, tq64, tk64 + 3 * (tk64 // 64)), \
            torch.float32
    if direction == "backward":
        return (2, batch, num_heads, tq64, tk64), torch.bfloat16
    raise ValueError("direction must be 'forward' or 'backward', got %r"
                     % (direction,))


def pad_heads(x: torch.Tensor, num_heads: int, dp: int) -> torch.Tensor:
    """[B, T, H*D] -> [B, T, H*dp], each head's channels zero-padded from D
    to dp (x itself when D == dp)."""
    b, t, c = x.shape
    d = c // num_heads
    if d == dp:
        return x
    return torch.nn.functional.pad(x.reshape(b, t, num_heads, d),
                                   (0, dp - d)).reshape(b, t, num_heads * dp)


def unpad_heads(x: torch.Tensor, num_heads: int, d: int) -> torch.Tensor:
    """[B, T, H*dp] -> [B, T, H*d], the first d channels of each head."""
    b, t, c = x.shape
    if c == num_heads * d:
        return x
    return x.reshape(b, t, num_heads, c // num_heads)[..., :d].reshape(
        b, t, num_heads * d)


def dropout_threshold(rate: float) -> int:
    """A key is kept when its 32-bit word is >= this (``_mask_from_bits``)."""
    return int(min(rate, 1.0) * 4294967296.0)


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit halves of m * c for uint32 values held in int64,
    without overflowing int64."""
    a = c * (m & 0xFFFF)
    b = c * (m >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 over int64 tensors of uint32 values (broadcasting)."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep_mask(seed: torch.Tensor, batch: int, num_heads: int,
                      tq: int, tk: int, rate: float,
                      head_offset: int = 0) -> torch.Tensor:
    """The kernels' dropout mask, [B, H, Tq, Tk] bool (True = kept): Philox
    keyed by the seed, counter (k // 4, q, head_offset + h, b), word
    k % 4."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64)
    key0, key1 = s & _MASK32, (s >> 32) & _MASK32
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    c0 = ar((tk + 3) // 4)[None, None, None, :]
    c1 = ar(tq)[None, None, :, None]
    c2 = (ar(num_heads) + head_offset)[None, :, None, None]
    c3 = ar(batch)[:, None, None, None]
    shape = (batch, num_heads, tq, c0.shape[-1])
    words = philox4x32_10(c0.expand(shape), c1.expand(shape),
                          c2.expand(shape), c3.expand(shape), key0, key1)
    bits = torch.stack(words, dim=-1).reshape(batch, num_heads, tq, -1)
    return bits[..., :tk] >= dropout_threshold(rate)


def _scores(q, k, bias, num_heads, causal, scale, use_bias):
    """(q_scaled_rounded . k^T + bias / causal mask) [B,H,Tq,Tk] fp32."""
    tq, tk = q.shape[1], k.shape[1]
    qh = (_split_heads_f32(q, num_heads) * scale).to(q.dtype).float()
    s = torch.matmul(qh, _split_heads_f32(k, num_heads).transpose(-1, -2))
    if use_bias:
        s = s + bias.float()[:, None, None, :]
    if causal:
        above = torch.ones(tq, tk, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    return s


def mha_forward_plain(q, k, v, bias, num_heads: int, causal: bool,
                      scale: float, use_bias: bool, rate: float = 0.0,
                      seed=None, head_offset: int = 0):
    """Plain PyTorch version of the kernel: (o [B,Tq,H*D], lse [B,Tq,H])."""
    b, tq, _ = q.shape
    s = _scores(q, k, bias, num_heads, causal, scale, use_bias)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0].transpose(1, 2).contiguous()
    keep = 1.0 - rate
    if rate > 0.0:
        p = torch.where(dropout_keep_mask(seed, b, num_heads, tq, k.shape[1],
                                          rate, head_offset),
                        p, torch.zeros_like(p))
    o = torch.matmul(p.to(v.dtype).float(), _split_heads_f32(v, num_heads)) \
        * (1.0 / torch.clamp(l * keep, min=1e-30))
    return _combine_heads(o, q.dtype), lse


def mha_backward_plain(q, k, v, bias, seed, o, lse, do, num_heads: int,
                       causal: bool, scale: float, use_bias: bool,
                       rate: float = 0.0, head_offset: int = 0):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv) in the
    input type, the TPU kernel's math and rounding points."""
    dt = q.dtype
    b, tq, _ = q.shape
    inv_keep = 1.0 / (1.0 - rate)
    doh = _split_heads_f32(do.to(dt), num_heads)
    # rowsum(do . o) as a product with one output: its sum does not depend
    # on how many zero channels follow, so padded heads give the same bits
    delta = torch.matmul(doh.unsqueeze(-2),
                         _split_heads_f32(o, num_heads).unsqueeze(-1))[..., 0]
    s = _scores(q, k, bias, num_heads, causal, scale, use_bias)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    g, dw = p, torch.matmul(doh, _split_heads_f32(v, num_heads)
                            .transpose(-1, -2))
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, num_heads, tq, k.shape[1], rate,
                                 head_offset)
        g = torch.where(keep, p, torch.zeros_like(p))
        dw = torch.where(keep, dw, torch.zeros_like(dw)) * inv_keep
    dv = torch.matmul(g.to(dt).float().transpose(-1, -2),
                      (doh * inv_keep).to(dt).float())
    dss = (p * (dw - delta) * scale).to(dt).float()
    dq = torch.matmul(dss, _split_heads_f32(k, num_heads))
    dk = torch.matmul(dss.transpose(-1, -2), _split_heads_f32(q, num_heads))
    return (_combine_heads(dq, dt), _combine_heads(dk, dt),
            _combine_heads(dv, dt))


def _check(q, k, v, bias, num_heads, causal, use_bias, rate, seed):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError("q must be [B,Tq,C] and k, v [B,Tk,C]; got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, tq, c = q.shape
    if k.shape[0] != b or k.shape[2] != c or c % num_heads:
        raise ValueError("mismatched q/k shapes %s %s for %d heads"
                         % (tuple(q.shape), tuple(k.shape), num_heads))
    if causal and k.shape[1] != tq:
        raise ValueError("causal attention needs Tq == Tk")
    if use_bias and (bias is None or tuple(bias.shape) != (b, k.shape[1])):
        raise ValueError("bias must be [B, Tk] when use_bias")
    if not 0.0 <= rate < 1.0:
        raise ValueError("dropout rate must be in [0, 1), got %r" % rate)
    if rate > 0.0 and (seed is None or seed.numel() != 1 or
                       seed.dtype != torch.int64 or seed.device != q.device):
        raise ValueError("dropout needs the seed as one int64 on q's device")


def _misaligned(t: torch.Tensor) -> bool:
    elt = t.element_size()
    return bool(t.data_ptr() % 16 or
                any(st * elt % 16 for st in t.stride()[:-1]))


def check_alignment(*tensors):
    """Raise unless each tensor's base address and its strides other than
    the last are multiples of 16 bytes: the bf16 kernels copy rows into
    shared memory with 16-byte ``cp.async`` and read them with ``ldmatrix``.
    Split views of a fused QKV or KV projection of a width that is a
    multiple of 8 pass as they are."""
    for t in tensors:
        if _misaligned(t):
            elt = t.element_size()
            raise ValueError(
                "the bf16 attention kernels need 16-byte aligned rows: base "
                "address %% 16 = %d, strides %s of %d-byte elements"
                % (t.data_ptr() % 16, tuple(t.stride()), elt))


def _check_cuda(q, k, v, bias, num_heads, use_bias, *others):
    if q.device.type != "cuda":
        raise ValueError("the attention kernels run on CPU or CUDA tensors, "
                         "not %s" % q.device)
    d = q.shape[2] // num_heads
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the kernel takes float32 or bfloat16 q/k/v of one "
                         "type, got %s %s %s" % (q.dtype, k.dtype, v.dtype))
    padded = kernel_head_dim(d) != d
    for t in (k, v) + others:
        if t.device != q.device:
            raise ValueError("every tensor must lie on q's device")
    for t in (q, k, v) + others:
        if t.stride(2) != 1:
            raise ValueError("q, k, v, o and do need a contiguous last dim")
    if q.dtype == torch.bfloat16 and not padded:   # padded: fresh copies
        check_alignment(q, k, v, *others)
    if use_bias and (bias.dtype != torch.float32 or
                     not bias.is_contiguous() or bias.device != q.device):
        raise ValueError("bias must be a contiguous float32 tensor on q's "
                         "device")


def _wide_workspace(direction, dp, q, num_heads, tk):
    """A fresh ``wide_workspace`` for ``csrc/mha_wide.cu`` in bf16 (head
    dim ``dp`` above 256), else None."""
    if dp <= KERNEL_HEAD_DIMS[-1] or q.dtype != torch.bfloat16:
        return None
    shape, dtype = wide_workspace(direction, q.shape[0], num_heads,
                                  q.shape[1], tk)
    return torch.empty(shape, dtype=dtype, device=q.device)


def _workspace_arg(dp, ws) -> tuple:
    """The workspace argument of ``csrc/mha_wide.cu`` (after lse, or after
    delta); the entries of the narrower head dims take none."""
    if dp <= KERNEL_HEAD_DIMS[-1]:
        return ()
    return (None if ws is None else ws.data_ptr(),)


def mha_forward(q, k, v, bias, num_heads: int, causal: bool, scale: float,
                use_bias: bool, rate: float = 0.0, seed=None,
                head_offset: int = 0):
    """Attention forward over packed heads: (o [B,Tq,H*D], lse [B,Tq,H]).

    q [B,Tq,H*D]; k, v [B,Tk,H*D], each with a contiguous last dim (row
    strides are free, so split views of a fused projection pass as they
    are; in bf16 they and the base address are 16-byte multiples).  bias
    [B,Tk] additive (used only with ``use_bias``).  ``causal`` masks keys
    after the query (Tq == Tk).  ``rate`` > 0 drops attention
    weights under the mask of ``seed`` (one int64 on q's device), its heads
    counted from ``head_offset`` (see the module's note).  CPU
    tensors take the plain version; CUDA tensors launch the kernel of the
    head dim rounded up to a multiple of 32 (padding each head, see the
    module's note) or raise.
    """
    with tracing.span("ops.mha_forward"):
        _check(q, k, v, bias, num_heads, causal, use_bias, rate, seed)
        if q.device.type == "cpu":
            return mha_forward_plain(q, k, v, bias, num_heads, causal, scale,
                                     use_bias, rate, seed, head_offset)
        _check_cuda(q, k, v, bias, num_heads, use_bias)
        d = q.shape[2] // num_heads
        dp = kernel_head_dim(d)
        q, k, v = (pad_heads(t, num_heads, dp) for t in (q, k, v))
        b, tq, c = q.shape
        tk = k.shape[1]
        fwd, err_string = _entry("mha_fwd", dp)
        o = torch.empty((b, tq, c), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, tq, num_heads), dtype=torch.float32,
                          device=q.device)
        ws = _wide_workspace("forward", dp, q, num_heads, tk)
        err = fwd(
            _DTYPE_CODES[q.dtype], c // num_heads, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr() if use_bias else None,
            seed.data_ptr() if rate > 0.0 else None, o.data_ptr(),
            lse.data_ptr(), *_workspace_arg(dp, ws), b, tq, tk, num_heads,
            head_offset,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1),
            float(scale), int(causal), int(use_bias), int(rate > 0.0),
            dropout_threshold(rate), float(1.0 - rate),
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError("mha_fwd launch failed: %s"
                               % err_string(err).decode())
        mha_forward.launches += 1
        return unpad_heads(o, num_heads, d), lse


def mha_backward(q, k, v, bias, seed, o, lse, do, num_heads: int,
                 causal: bool, scale: float, use_bias: bool,
                 rate: float = 0.0, head_offset: int = 0):
    """Gradients (dq, dk, dv) of ``mha_forward``'s o, in the input type.

    Takes the forward's inputs and its (o, lse), and ``do`` [B,Tq,H*D].  The
    bias gets no gradient.  CPU tensors take the plain version; CUDA tensors
    launch the kernels of ``csrc/mha_bwd.cu`` (above head dim 256
    ``csrc/mha_wide.cu``; counted as one call; a head dim that is not a
    multiple of 32 padded as in ``mha_forward``) or raise."""
    with tracing.span("ops.mha_backward"):
        _check(q, k, v, bias, num_heads, causal, use_bias, rate, seed)
        if q.device.type == "cpu":
            return mha_backward_plain(q, k, v, bias, seed, o, lse, do,
                                      num_heads, causal, scale, use_bias,
                                      rate, head_offset)
        if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or \
                lse.shape != (q.shape[0], q.shape[1], num_heads) or \
                lse.dtype != torch.float32 or not lse.is_contiguous() or \
                lse.device != q.device:
            raise ValueError("o and do must be [B,Tq,C], o in q's type, and "
                             "lse a contiguous float32 [B,Tq,H] on q's "
                             "device")
        if do.dtype != q.dtype or do.stride(2) != 1 or _misaligned(do):
            do = do.to(q.dtype, memory_format=torch.contiguous_format,
                       copy=True)
        _check_cuda(q, k, v, bias, num_heads, use_bias, o, do)
        d = q.shape[2] // num_heads
        dp = kernel_head_dim(d)
        q, k, v, o, do = (pad_heads(t, num_heads, dp)
                          for t in (q, k, v, o, do))
        b, tq, c = q.shape
        tk = k.shape[1]
        bwd, err_string = _entry("mha_bwd", dp)
        dq = torch.empty((b, tq, c), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, tk, c), dtype=q.dtype, device=q.device)
        dv = torch.empty((b, tk, c), dtype=q.dtype, device=q.device)
        delta = torch.empty((b, tq, num_heads), dtype=torch.float32,
                            device=q.device)
        ws = _wide_workspace("backward", dp, q, num_heads, tk)
        err = bwd(
            _DTYPE_CODES[q.dtype], c // num_heads, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr() if use_bias else None,
            seed.data_ptr() if rate > 0.0 else None, o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(),
            delta.data_ptr(), *_workspace_arg(dp, ws), b, tq, tk, num_heads,
            head_offset, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), o.stride(0), o.stride(1), do.stride(0),
            do.stride(1),
            float(scale), int(causal),
            int(use_bias), int(rate > 0.0), dropout_threshold(rate),
            float(1.0 / (1.0 - rate)),
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError("mha_bwd launch failed: %s"
                               % err_string(err).decode())
        mha_backward.launches += 1
        return tuple(unpad_heads(t, num_heads, d) for t in (dq, dk, dv))


# Kernel launches since the count was last reset (tests and chip_smoke.py
# read them to show that a path went through the kernels).
mha_forward.launches = 0
mha_backward.launches = 0


class MhaFunction(torch.autograd.Function):
    """``mha_forward``'s o, differentiable in q, k and v through
    ``mha_backward``.  The forward saves q, k, v, bias, seed, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, num_heads: int, causal: bool,
                scale: float, use_bias: bool, rate: float,
                head_offset: int = 0):
        o, lse = mha_forward(q, k, v, bias, num_heads, causal, scale,
                             use_bias, rate, seed, head_offset)
        ctx.save_for_backward(q, k, v, bias, seed, o, lse)
        ctx.config = (num_heads, causal, scale, use_bias, rate, head_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed, o, lse = ctx.saved_tensors
        dq, dk, dv = mha_backward(q, k, v, bias, seed, o, lse, do,
                                  *ctx.config)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def draw_seed(generator, device) -> torch.Tensor:
    """One int64 dropout seed on ``device`` from ``generator`` (that
    device's generator, or None for the default one); no host sync."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=device, dtype=torch.int64)


_FWD_ARGS = "i i p p p p p p p i i i i i ll ll ll ll ll ll f i i i u f p"
_BWD_ARGS = ("i i p p p p p p p p p p p p i i i i i ll ll ll ll ll ll ll ll "
             "ll ll f i i i u f p")
# csrc/mha_wide.cu's: the workspace after lse (forward) or delta
_WIDE_FWD_ARGS = ("i i p p p p p p p p i i i i i ll ll ll ll ll ll f i i i u "
                  "f p")
_WIDE_BWD_ARGS = ("i i p p p p p p p p p p p p p i i i i i ll ll ll ll ll ll "
                  "ll ll ll ll f i i i u f p")
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint,
           "f": ctypes.c_float, "ll": ctypes.c_longlong}


def _bind(fn, spec: str, restype=ctypes.c_int):
    fn.argtypes = [_CTYPES[c] for c in spec.split()]
    fn.restype = restype
    return fn


@functools.lru_cache(maxsize=None)
def _entry(name: str, head_dim: int):
    """(entry, error string) of kernel ``name`` ("mha_fwd" or "mha_bwd")
    for head dim ``head_dim`` (a value of ``kernel_head_dim``): from the
    library of that head dim up to 256, from ``csrc/mha_wide.cu`` above."""
    spec = _FWD_ARGS if name == "mha_fwd" else _BWD_ARGS
    if head_dim > KERNEL_HEAD_DIMS[-1]:
        spec = _WIDE_FWD_ARGS if name == "mha_fwd" else _WIDE_BWD_ARGS
        lib = cuda_build.load("mha_wide")
        fn = getattr(lib, name.replace("mha_", "mha_wide_"))
        err = lib.mha_wide_error_string
    else:
        lib = cuda_build.load(name, head_dim)
        fn, err = getattr(lib, name), getattr(lib, name + "_error_string")
    return _bind(fn, spec), _bind(err, "i", ctypes.c_char_p)
