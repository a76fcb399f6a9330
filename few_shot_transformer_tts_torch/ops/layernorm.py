"""LayerNorm forward with the JAX package's numerics (counterpart of
``reference_ln`` in ``few_shot_transformer_tts_tpu/ops/fused_layernorm.py``).

Statistics are fp32 as E[x^2] - E[x]^2 clamped at 0, eps 1e-6 sits inside the
rsqrt, and the output takes x's type.  ``torch.nn.LayerNorm`` computes the
variance as E[(x - mean)^2] and returns the parameters' type, so it is not
used.  The TPU kernel of that file is a backward only; its port comes with
the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    mean2 = (x32 * x32).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return ((x32 - mean) * rstd * weight.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """Parameters ``weight``/``bias`` (fp32) under the reference names."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
