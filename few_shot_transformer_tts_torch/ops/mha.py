"""Multi-head attention forward in the packed [B, T, H*D] layout.

Counterpart of the forward of ``mha_train``
(``few_shot_transformer_tts_tpu/ops/pallas_attention_train.py``) at dropout
rate 0.  ``mha_forward`` launches the hand-written CUDA kernel
``csrc/mha_fwd.cu`` for CUDA tensors and takes ``mha_forward_plain``, the same
math in plain PyTorch, only for CPU tensors.  The plain version is also what
the tests and ``chip_smoke.py`` hold the kernel against; nothing on the main
path calls it when a card is present.

Semantics kept from the TPU kernel: q is scaled in fp32 and rounded back to
its type before the dot; scores, the softmax statistics and ``lse = m + log l``
are fp32; causal masking writes -1e20; keys at or beyond Tk are excluded;
``p`` is cast to v's type before the P.V product; ``o = acc / max(l, 1e-30)``
in q's type.  ``lse`` is returned [B, Tq, H] for the backward of the training
slice, which also brings dropout (``rate > 0`` raises until then).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NEG_INF = -1e20
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96)


def _split_heads_f32(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2).float()


def mha_forward_plain(q, k, v, bias, num_heads: int, causal: bool,
                      scale: float, use_bias: bool):
    """Plain PyTorch version of the kernel: (o [B,Tq,H*D], lse [B,Tq,H])."""
    b, tq, c = q.shape
    tk = k.shape[1]
    qh = (_split_heads_f32(q, num_heads) * scale).to(q.dtype).float()
    kh = _split_heads_f32(k, num_heads)
    vh = _split_heads_f32(v, num_heads)
    s = torch.matmul(qh, kh.transpose(-1, -2))          # [B,H,Tq,Tk] fp32
    if use_bias:
        s = s + bias.float()[:, None, None, :]
    if causal:
        above = torch.ones(tq, tk, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0].transpose(1, 2).contiguous()
    o = torch.matmul(p.to(v.dtype).float(), vh) * \
        (1.0 / torch.clamp(l, min=1e-30))
    return o.transpose(1, 2).reshape(b, tq, c).to(q.dtype), lse


def _check(q, k, v, bias, num_heads, causal, use_bias):
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


def mha_forward(q, k, v, bias, num_heads: int, causal: bool, scale: float,
                use_bias: bool, rate: float = 0.0):
    """Attention forward over packed heads: (o [B,Tq,H*D], lse [B,Tq,H]).

    q [B,Tq,H*D]; k, v [B,Tk,H*D], each with a contiguous last dim (row
    strides are free, so split views of a fused projection pass as they
    are).  bias [B,Tk] additive (used only with ``use_bias``).  ``causal``
    masks keys after the query (Tq == Tk).  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    if rate != 0.0:
        raise NotImplementedError(
            "attention dropout (rate > 0) comes with the training slice")
    _check(q, k, v, bias, num_heads, causal, use_bias)
    if q.device.type == "cpu":
        return mha_forward_plain(q, k, v, bias, num_heads, causal, scale,
                                 use_bias)
    if q.device.type != "cuda":
        raise ValueError("mha_forward runs on CPU or CUDA tensors, not %s"
                         % q.device)
    b, tq, c = q.shape
    tk = k.shape[1]
    d = c // num_heads
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the kernel takes float32 or bfloat16 q/k/v of one "
                         "type, got %s %s %s" % (q.dtype, k.dtype, v.dtype))
    if d not in _HEAD_DIMS:
        raise ValueError("the kernel takes head dim 64 or 96, got %d" % d)
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    if q.stride(2) != 1 or k.stride(2) != 1 or v.stride(2) != 1:
        raise ValueError("q, k, v need a contiguous last dim")
    if use_bias:
        if bias.dtype != torch.float32 or not bias.is_contiguous() or \
                bias.device != q.device:
            raise ValueError("bias must be a contiguous float32 tensor on "
                             "q's device")
    lib = _library()
    o = torch.empty((b, tq, c), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, tq, num_heads), dtype=torch.float32, device=q.device)
    err = lib.mha_fwd(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if use_bias else None, o.data_ptr(), lse.data_ptr(),
        b, tq, tk, num_heads, q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), float(scale), int(causal),
        int(use_bias), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("mha_fwd launch failed: %s"
                           % lib.mha_fwd_error_string(err).decode())
    mha_forward.launches += 1
    return o, lse


# Kernel launches since the count was last reset (tests and chip_smoke.py
# read it to show that a path went through the kernel).
mha_forward.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("mha_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mha_fwd.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i,
                            ll, ll, ll, ll, ll, ll, ctypes.c_float, i, i, p]
    lib.mha_fwd.restype = i
    lib.mha_fwd_error_string.argtypes = [i]
    lib.mha_fwd_error_string.restype = ctypes.c_char_p
    return lib
