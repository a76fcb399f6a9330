"""LayerNorm with the JAX package's numerics: the plain forward
(``reference_ln`` in ``few_shot_transformer_tts_tpu/ops/fused_layernorm.py``)
and the backward of its TPU kernel ``fused_layer_norm``.

Statistics are fp32 as E[x^2] - E[x]^2 clamped at 0, eps 1e-6 sits inside the
rsqrt, and the output takes x's type.  ``torch.nn.LayerNorm`` computes the
variance as E[(x - mean)^2] and returns the parameters' type, so it is not
used.

``layer_norm_backward`` gives (dx in x's type, dgamma, dbeta in fp32): for
CUDA tensors it launches ``csrc/layernorm_bwd.cu``, for CPU tensors it takes
``layer_norm_backward_plain``, the same math in plain PyTorch (also what the
tests and ``chip_smoke.py`` hold the kernel against).  ``LayerNormFunction``
pairs the plain forward with that backward, as the JAX package pairs
``reference_ln`` with its kernel; ``LayerNorm(fused=True)`` uses it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import nn

from . import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_COLS = 1024
_BLOCKS = 264          # two blocks on each of the H100's 132 SMs


def _stats(x32: torch.Tensor, eps: float):
    mean = x32.mean(-1, keepdim=True)
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean, rstd = _stats(x32, eps)
    return ((x32 - mean) * rstd * weight.float() + bias.float()).to(x.dtype)


def layer_norm_backward_plain(x: torch.Tensor, gamma: torch.Tensor,
                              dy: torch.Tensor, eps: float = 1e-6):
    """Plain PyTorch version of the kernel (the TPU kernel's ``_bwd_kernel``
    math): (dx [x.shape] in x's type, dgamma [C], dbeta [C] fp32)."""
    c = x.shape[-1]
    x32 = x.reshape(-1, c).float()
    dy32 = dy.reshape(-1, c).float()
    mean, rstd = _stats(x32, eps)
    xhat = (x32 - mean) * rstd
    g = dy32 * gamma.float()
    s1 = (g * xhat).mean(-1, keepdim=True)
    s2 = g.mean(-1, keepdim=True)
    dx = (rstd * (g - xhat * s1 - s2)).to(x.dtype).reshape(x.shape)
    return dx, (dy32 * xhat).sum(0), dy32.sum(0)


def layer_norm_backward(x: torch.Tensor, gamma: torch.Tensor,
                        dy: torch.Tensor, eps: float = 1e-6):
    """(dx, dgamma, dbeta) of ``layer_norm`` over the last axis.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (two
    kernels, counted as one call) or raise."""
    if x.device.type == "cpu":
        return layer_norm_backward_plain(x, gamma, dy, eps)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_backward runs on CPU or CUDA tensors, "
                         "not %s" % x.device)
    c = x.shape[-1]
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype or \
            dy.shape != x.shape:
        raise ValueError("the kernel takes float32 or bfloat16 x and dy of "
                         "one type and shape, got %s %s %s %s"
                         % (x.dtype, dy.dtype, tuple(x.shape),
                            tuple(dy.shape)))
    if not 1 <= c <= _MAX_COLS:
        raise ValueError("the kernel takes 1 to %d columns, got %d"
                         % (_MAX_COLS, c))
    if gamma.shape != (c,) or gamma.dtype != torch.float32 or \
            gamma.device != x.device or dy.device != x.device:
        raise ValueError("gamma must be float32 [C] and dy on x's device")
    x2 = x.reshape(-1, c).contiguous()
    dy2 = dy.reshape(-1, c).contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx.reshape(x.shape), dgamma.zero_(), dbeta.zero_()
    blocks = min(-(-rows // 8), _BLOCKS)
    rows_per_block = -(-rows // blocks)
    blocks = -(-rows // rows_per_block)
    partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                          device=x.device)
    lib = _library()
    err = lib.ln_bwd(_DTYPE_CODES[x.dtype], x2.data_ptr(),
                     gamma.contiguous().data_ptr(), dy2.data_ptr(),
                     dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                     partial.data_ptr(), rows, c, rows_per_block, blocks,
                     float(eps),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("ln_bwd launch failed: %s"
                           % lib.ln_bwd_error_string(err).decode())
    layer_norm_backward.launches += 1
    return dx.reshape(x.shape), dgamma, dbeta


# Kernel calls since the count was last reset (chip_smoke.py reads it).
layer_norm_backward.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("layernorm_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ln_bwd.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i,
                           ctypes.c_float, p]
    lib.ln_bwd.restype = i
    lib.ln_bwd_error_string.argtypes = [i]
    lib.ln_bwd_error_string.restype = ctypes.c_char_p
    return lib


class LayerNormFunction(torch.autograd.Function):
    """``layer_norm`` forward, ``layer_norm_backward`` backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return layer_norm(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_backward(x, weight, dy.to(x.dtype),
                                                ctx.eps)
        return dx, dgamma, dbeta, None


class LayerNorm(nn.Module):
    """Parameters ``weight``/``bias`` (fp32) under the reference names.
    ``fused`` (``hp.use_fused_layernorm``) takes the backward kernel."""

    def __init__(self, features: int, eps: float = 1e-6, fused: bool = False):
        super().__init__()
        self.eps = eps
        self.fused = fused
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused and torch.is_grad_enabled():
            return LayerNormFunction.apply(x, self.weight, self.bias,
                                           self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)
