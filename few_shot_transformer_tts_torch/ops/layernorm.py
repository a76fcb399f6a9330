"""LayerNorm with the JAX package's numerics: the plain forward
(``reference_ln`` in ``few_shot_transformer_tts_tpu/ops/fused_layernorm.py``)
and the backward of its TPU kernel ``fused_layer_norm``.

Statistics are fp32 as E[x^2] - E[x]^2 clamped at 0, eps 1e-6 sits inside the
rsqrt, and the output takes x's type.  ``torch.nn.LayerNorm`` computes the
variance as E[(x - mean)^2] and returns the parameters' type, so it is not
used.

``layer_norm_backward`` gives (dx in x's type, dgamma, dbeta in fp32): for
CUDA tensors it launches ``csrc/layernorm_bwd.cu`` once (a cooperative grid
that ``ln_bwd_plan`` sizes, with a workspace and a grid barrier count kept
per device and stream), for CPU tensors it takes
``layer_norm_backward_plain``, the same math in plain PyTorch (also what the
tests and ``chip_smoke.py`` hold the kernel against).  ``LayerNormFunction``
pairs the plain forward with that backward, as the JAX package pairs
``reference_ln`` with its kernel; ``LayerNorm(fused=True)`` uses it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch import nn

from . import cuda_build
from ..utils import tracing

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COLS = 1024
WARPS_PER_BLOCK = 8    # csrc/layernorm_bwd.cu kWarps
# values per lane of each instantiation of csrc/layernorm_bwd.cu (LN_ALL):
# the 16-byte variant holds whole vectors (8 bf16 or 4 fp32 columns each)
VECTOR_PER_LANE = {torch.bfloat16: (8, 16, 24, 32),
                   torch.float32: (4, 8, 16, 24, 32)}
SCALAR_PER_LANE = (2, 4, 8, 16, 24, 32)
# the vector variant's ring of row slots (x and dy) per warp: 2 to 4 slots,
# as many as fit this many bytes over the block's warps
RING_BYTES = 96 * 1024
MAX_DEPTH = 4
# blocks per SM at most (fewer where the occupancy allows fewer): on the
# H100 two blocks per SM were slower than one at the train shapes (the
# tail sums twice the partial rows)
BLOCKS_PER_SM = 1


class LnBwdPlan(NamedTuple):
    """One ``ln_bwd`` launch: the variant (``vector``: 16-byte loads through
    a ring of ``depth`` row slots per warp; 0 for the scalar variant), the
    instantiation's values per lane, the dynamic shared memory, the grid,
    the rows of each block (block i owns rows [i * rows_per_block, (i + 1) *
    rows_per_block)) and the fp32 workspace of one partial [dgamma, dbeta]
    row per block."""
    vector: bool
    per_lane: int
    depth: int
    smem_bytes: int
    grid: int
    rows_per_block: int
    workspace_floats: int


def ln_bwd_variant(cols: int, dtype: torch.dtype, aligned: bool):
    """(vector, per_lane): the 16-byte variant when the pointers are 16-byte
    aligned and a row is a whole number of 16-byte vectors, else the scalar
    one; the smallest instantiation that holds ``cols`` columns per row."""
    if not 1 <= cols <= MAX_COLS:
        raise ValueError("the kernel takes 1 to %d columns, got %d"
                         % (MAX_COLS, cols))
    elt = torch.finfo(dtype).bits // 8
    vector = aligned and cols * elt % 16 == 0
    if vector:
        per_vec = 16 // elt
        need = -(-cols // (32 * per_vec)) * per_vec
        sizes = VECTOR_PER_LANE[dtype]
    else:
        need, sizes = -(-cols // 32), SCALAR_PER_LANE
    return vector, next(k for k in sizes if k >= need)


def ln_bwd_smem(cols: int, dtype: torch.dtype, vector: bool):
    """(ring depth, dynamic shared memory bytes) of a launch: the vector
    variant's ring of x and dy rows, which the block's [8, 2 cols] fp32
    sums reuse afterwards; the scalar variant has only the sums."""
    sums = WARPS_PER_BLOCK * 2 * cols * 4
    if not vector:
        return 0, sums
    slot = 2 * cols * (torch.finfo(dtype).bits // 8)
    depth = min(MAX_DEPTH, max(2, RING_BYTES // (WARPS_PER_BLOCK * slot)))
    return depth, max(WARPS_PER_BLOCK * depth * slot, sums)


def ln_bwd_plan(rows: int, cols: int, dtype: torch.dtype, aligned: bool,
                sms: int, blocks_per_sm: int) -> LnBwdPlan:
    """The launch of ``ln_bwd`` for x [rows, cols]: at most ``sms *
    min(blocks_per_sm, BLOCKS_PER_SM)`` blocks (the cooperative launch needs
    them co-resident; ``blocks_per_sm`` of this variant at its shared
    memory), at least a warp's row each, every row in exactly one block's
    range."""
    if rows < 1 or sms < 1 or blocks_per_sm < 1:
        raise ValueError("ln_bwd_plan needs rows, SMs and blocks per SM "
                         "of at least 1, got %d, %d, %d"
                         % (rows, sms, blocks_per_sm))
    vector, per_lane = ln_bwd_variant(cols, dtype, aligned)
    depth, smem = ln_bwd_smem(cols, dtype, vector)
    grid = min(sms * min(blocks_per_sm, BLOCKS_PER_SM),
               -(-rows // WARPS_PER_BLOCK))
    rows_per_block = -(-rows // grid)
    grid = -(-rows // rows_per_block)
    return LnBwdPlan(vector, per_lane, depth, smem, grid, rows_per_block,
                     grid * 2 * cols)


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


TRACE_STAMPS = ("start", "rows_done", "partial_written", "barrier_passed",
                "end")


def layer_norm_backward(x: torch.Tensor, gamma: torch.Tensor,
                        dy: torch.Tensor, eps: float = 1e-6, trace=None):
    """(dx, dgamma, dbeta) of ``layer_norm`` over the last axis.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch) or raise.  Calls on one stream run one after another: they
    share its workspace and grid barrier.  ``trace``, a contiguous int64
    CUDA tensor of at least grid x len(TRACE_STAMPS) elements (the grid of
    ``ln_bwd_plan``), receives each block's global-timer stamps (ns) in
    TRACE_STAMPS order."""
    with tracing.span("ops.layer_norm_backward"):
        if x.device.type == "cpu":
            return layer_norm_backward_plain(x, gamma, dy, eps)
        check_kernel_args(x, gamma, dy)
        c = x.shape[-1]
        x2 = x.reshape(-1, c).contiguous()
        dy2 = dy.reshape(-1, c).contiguous()
        rows = x2.shape[0]
        dx = torch.empty_like(x2)
        grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
        if rows == 0:
            return dx.reshape(x.shape), *grads.zero_()
        aligned = (x2.data_ptr() | dy2.data_ptr() | dx.data_ptr()) % 16 == 0
        stream = torch.cuda.current_stream(x.device).cuda_stream
        plan = _plan(x.device, rows, c, x.dtype, aligned)
        partial, bar = _state(x.device, stream, plan)
        if trace is not None and (
                trace.dtype != torch.int64 or trace.device != x.device or
                not trace.is_contiguous() or
                trace.numel() < plan.grid * len(TRACE_STAMPS)):
            raise ValueError("trace must be a contiguous int64 tensor of %d "
                             "elements on x's device"
                             % (plan.grid * len(TRACE_STAMPS)))
        lib = _library()
        g = grads.data_ptr()
        err = lib.ln_bwd(_DTYPE_CODES[x.dtype], plan.vector, plan.per_lane,
                         plan.depth, x2.data_ptr(),
                         gamma.contiguous().data_ptr(),
                         dy2.data_ptr(), dx.data_ptr(), g, g + 4 * c, partial,
                         bar, rows, c, plan.rows_per_block, plan.grid,
                         plan.smem_bytes, eps,
                         None if trace is None else trace.data_ptr(), stream)
        if err != 0:
            raise RuntimeError("ln_bwd launch failed: %s"
                               % lib.ln_bwd_error_string(err).decode())
        layer_norm_backward.launches += 1
        return dx.reshape(x.shape), *grads.unbind()


def check_kernel_args(x: torch.Tensor, gamma: torch.Tensor,
                      dy: torch.Tensor) -> None:
    """Raise ValueError for what the kernel does not take: a device other
    than CUDA, types other than float32 or bfloat16 x and dy of one type
    and shape, more than MAX_COLS columns, gamma not float32 [C] on x's
    device."""
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
    if not 1 <= c <= MAX_COLS:
        raise ValueError("the kernel takes 1 to %d columns, got %d"
                         % (MAX_COLS, c))
    if gamma.shape != (c,) or gamma.dtype != torch.float32 or \
            gamma.device != x.device or dy.device != x.device:
        raise ValueError("gamma must be float32 [C] and dy on x's device")


# Kernel launches since the count was last reset (chip_smoke.py reads it).
layer_norm_backward.launches = 0


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device: torch.device, dtype: torch.dtype, vector: bool,
                   per_lane: int, smem: int) -> int:
    """Co-resident blocks of one instantiation on an SM of ``device`` at
    ``smem`` bytes of shared memory
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library().ln_bwd_blocks_per_sm(
            _DTYPE_CODES[dtype], int(vector), per_lane, smem,
            ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError("ln_bwd fits no block on an SM: %s" % (
            _library().ln_bwd_error_string(err).decode() if err else
            "0 blocks"))
    return out.value


@functools.lru_cache(maxsize=4096)
def _plan(device: torch.device, rows: int, cols: int, dtype: torch.dtype,
          aligned: bool) -> LnBwdPlan:
    vector, per_lane = ln_bwd_variant(cols, dtype, aligned)
    smem = ln_bwd_smem(cols, dtype, vector)[1]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return ln_bwd_plan(rows, cols, dtype, aligned, sms,
                       _blocks_per_sm(device, dtype, vector, per_lane, smem))


# per (device, stream): the fp32 workspace of partial rows and one int64
# arrival count per grid size, both grown when a call needs more and kept
_STATE = {}


def _state(device: torch.device, stream: int, plan: LnBwdPlan):
    """(workspace pointer, barrier count pointer) for ``plan`` on
    ``stream``."""
    key = (device, stream)
    work, bars = _STATE.get(key, (None, None))
    if work is None or work.numel() < plan.workspace_floats:
        work = torch.empty(plan.workspace_floats, dtype=torch.float32,
                           device=device)
    if bars is None or bars.numel() <= plan.grid:
        grown = torch.zeros(plan.grid + 1, dtype=torch.int64, device=device)
        if bars is not None:
            grown[:bars.numel()] = bars
        bars = grown
    _STATE[key] = (work, bars)
    return work.data_ptr(), bars.data_ptr() + 8 * plan.grid


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("layernorm_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ln_bwd.argtypes = [i, i, i, i, p, p, p, p, p, p, p, p, i, i, i, i,
                           i, ctypes.c_float, p, p]
    lib.ln_bwd.restype = i
    lib.ln_bwd_blocks_per_sm.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.ln_bwd_blocks_per_sm.restype = i
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
