"""One-pass Adam; counterpart of ``few_shot_transformer_tts_tpu/ops/
fused_adam.py`` (``fused_adam_step``).

The recurrence is the TPU kernel's, with eps outside the square root as in
``torch.optim.Adam`` and optax:

    m' = b1 m + (1 - b1) g
    v' = b2 v + (1 - b2) g^2
    p' = p - a m' / (r sqrt(v') + eps),  a = lr / (1 - b1^t),
                                         r = (1 - b2^t)^(-1/2)

with t the post-increment step count and lr the schedule at the
pre-increment count (``LambdaLR`` sets it before the step).  ``a`` and
``r`` are computed in Python float64, as ``torch.optim.Adam`` computes its
bias corrections (the JAX package computes them in fp32 on the device).

Leaves are routed as in the JAX package (``fused_adam.py:143-151``): fp32
leaves of at least 2^20 elements whose JAX-layout shape is 2-D with a minor
dimension divisible by 128 take the kernel (``adam_leaves``, the
counterpart of the JAX package's map of the kernel over the tree: for CUDA
tensors ``csrc/fused_adam.cu``, one launch over the whole list, up to 64
leaves a launch; for CPU tensors the plain version); all others take
``adam_leaf_plain``, the same math as PyTorch tensor ops (foreach over the
list of leaves).  The JAX layout of an
``nn.Linear`` weight is its transpose; ``kernel_leaf_params`` applies that,
which selects the same 37 leaves at ``default_config()`` as the JAX package.

``FusedAdam`` is a ``torch.optim.Adam`` whose ``step`` takes this route.
It keeps Adam's ``state_dict`` layout (``step``, ``exp_avg``,
``exp_avg_sq``; the same ``param_groups`` keys), so a checkpoint saved under
either optimizer restores under the other.  Unlike the JAX package, which
returns new trees, the port updates parameters and moments in place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, List, Sequence

import torch
from torch import nn

from . import cuda_build

MIN_KERNEL_SIZE = 1 << 20


def is_kernel_leaf(jax_shape: Sequence[int], dtype: torch.dtype) -> bool:
    """The JAX package's routing of one leaf, by its shape in the JAX
    layout: fp32, 2-D, at least 2^20 elements, minor dimension % 128 == 0
    (``ops/fused_adam.py:146-147``)."""
    numel = 1
    for d in jax_shape:
        numel *= d
    return (numel >= MIN_KERNEL_SIZE and dtype == torch.float32 and
            len(jax_shape) == 2 and jax_shape[-1] % 128 == 0)


def kernel_leaf_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters of ``model`` that take the kernel: each judged in the
    JAX layout (an ``nn.Linear`` weight [out, in] is a flax Dense kernel
    [in, out]; embeddings keep their layout; convolutions are 3-D in both),
    a tensor-parallel rank's part of a weight by the whole weight's shape
    (``param.tp``), so every rank routes the same leaves as one device."""
    out = []
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            spec = getattr(p, "tp", None)
            shape = tuple(p.shape) if spec is None else spec.full_shape
            if isinstance(mod, nn.Linear) and name == "weight":
                shape = shape[::-1]
            if is_kernel_leaf(shape, p.dtype):
                out.append(p)
    return out


def adam_leaf_plain(params, grads, exp_avgs, exp_avg_sqs, a: float, r: float,
                    b1: float, b2: float, eps: float) -> None:
    """Plain PyTorch version of the kernel (the JAX ``_adam_leaf_jnp``), in
    place over lists of leaves: one tensor op per term (foreach), each
    rounded once, in the kernel's order."""
    if not params:
        return
    torch._foreach_mul_(exp_avgs, b1)
    torch._foreach_add_(exp_avgs, torch._foreach_mul(grads, 1.0 - b1))
    g2 = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(g2, 1.0 - b2)
    torch._foreach_mul_(exp_avg_sqs, b2)
    torch._foreach_add_(exp_avg_sqs, g2)
    denom = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_mul_(denom, r)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_mul(exp_avgs, a)
    torch._foreach_div_(update, denom)
    torch._foreach_sub_(params, update)


def check_leaves(params, grads, exp_avgs, exp_avg_sqs):
    """The kernel's rule for a list of leaves, checked once over the list:
    four lists of one length; each leaf's p, g, m, v contiguous float32 of
    one shape, 16-byte aligned, every tensor on the first one's device.
    Returns (the 4 pointers of each leaf with elements, in p, g, m, v
    order; their lengths); raises ValueError."""
    n = len(params)
    if not len(grads) == len(exp_avgs) == len(exp_avg_sqs) == n:
        raise ValueError("params, grads, exp_avgs and exp_avg_sqs must be "
                         "lists of one length")
    dev = params[0].device if n else None
    ptrs, lengths = [], []
    for leaf in zip(params, grads, exp_avgs, exp_avg_sqs):
        shape = leaf[0].shape
        for t in leaf:
            if t.device != dev or t.dtype != torch.float32 or \
                    t.shape != shape or not t.is_contiguous() or \
                    t.data_ptr() % 16:
                raise ValueError(
                    "the kernel takes contiguous, 16-byte aligned float32 "
                    "p, g, m, v of one shape, all on %s; got %s %s %s at "
                    "address %% 16 = %d" % (dev, t.device, t.dtype,
                                            tuple(t.shape),
                                            t.data_ptr() % 16))
        if leaf[0].numel():
            ptrs.extend(t.data_ptr() for t in leaf)
            lengths.append(leaf[0].numel())
    return ptrs, lengths


def adam_leaves(params, grads, exp_avgs, exp_avg_sqs, a: float, r: float,
                b1: float, b2: float, eps: float) -> None:
    """One Adam step over lists of leaves, in place.  CPU tensors take the
    plain version; CUDA tensors are checked once over the list
    (``check_leaves``) and take one kernel launch per 64 leaves (the
    kernel's leaf table; one launch for the flagship's 37), or raise."""
    if not params:
        return
    dev = params[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("adam_leaves runs on CPU or CUDA tensors, not %s"
                         % dev)
    if dev.type == "cpu":
        return adam_leaf_plain(params, grads, exp_avgs, exp_avg_sqs, a, r,
                               b1, b2, eps)
    ptrs, lengths = check_leaves(params, grads, exp_avgs, exp_avg_sqs)
    if not lengths:
        return
    lib = _library()
    k = len(lengths)
    launched = lib.adam_leaves(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_longlong * k)(*lengths), k, a, r, b1, 1.0 - b1, b2,
        1.0 - b2, eps, torch.cuda.current_stream(dev).cuda_stream)
    if launched <= 0:
        raise RuntimeError("adam_leaves launch failed: %s"
                           % lib.adam_leaves_error_string(-launched).decode())
    adam_leaves.launches += launched


def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, a: float, r: float, b1: float, b2: float,
              eps: float) -> None:
    """One leaf's update in place: ``adam_leaves`` over a list of one."""
    adam_leaves([p], [g], [m], [v], a, r, b1, b2, eps)


# Kernel launches since the count was last reset (chip_smoke.py reads it).
adam_leaves.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_adam")
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.adam_leaves.argtypes = [p, p, i, f, f, f, f, f, f, f, p]
    lib.adam_leaves.restype = i
    lib.adam_leaves_error_string.argtypes = [i]
    lib.adam_leaves_error_string.restype = ctypes.c_char_p
    return lib


class FusedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` with the one-pass update above.

    ``kernel_params`` are the leaves that take the kernel (for a model,
    ``kernel_leaf_params(model)``: the layout of a parameter does not say
    whether it is a transposed Dense kernel).  The parameters of a group
    step together, under one step count, as the JAX package's one count.
    Weight decay, amsgrad and maximize are not supported (the reference
    uses none)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, *,
                 kernel_params: Iterable[torch.Tensor]):
        super().__init__(params, lr=lr, betas=betas, eps=eps)
        self._kernel_ids = {id(p) for p in kernel_params}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            if group["weight_decay"] or group["amsgrad"] or \
                    group["maximize"]:
                raise ValueError("FusedAdam supports no weight decay, "
                                 "amsgrad or maximize")
            b1, b2 = (float(b) for b in group["betas"])
            params = [p for p in group["params"] if p.grad is not None]
            for p in params:
                if p.grad.is_sparse or p.is_complex():
                    raise ValueError("FusedAdam takes dense real gradients")
                state = self.state[p]
                if len(state) == 0:   # torch.optim.Adam's layout
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            if not params:
                continue
            steps = [self.state[p]["step"] for p in params]
            torch._foreach_add_(steps, 1.0)
            counts = torch.stack(steps)
            t = float(counts[0])
            if not bool((counts == t).all()):
                raise ValueError("FusedAdam steps a group's parameters "
                                 "together; their step counts differ")
            a = float(group["lr"]) / (1.0 - b1 ** t)
            r = (1.0 - b2 ** t) ** -0.5
            coef = (a, r, b1, b2, float(group["eps"]))
            kernel, plain = [], []
            for p in params:
                (kernel if id(p) in self._kernel_ids else plain).append(p)
            for route, leaves in ((adam_leaves, kernel),
                                  (adam_leaf_plain, plain)):
                route(leaves, [p.grad for p in leaves],
                      [self.state[p]["exp_avg"] for p in leaves],
                      [self.state[p]["exp_avg_sq"] for p in leaves], *coef)
        return loss
