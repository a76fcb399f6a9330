"""Random weights from the run's seed, made on the device in a few large
calls, in float32 (the type the program holds its parameters in).

The distributions are the reference implementation's initialisers
(``reference/model.py:param_spec``); the numbers come from one generator on
the device, so the same seed gives the same weights, and both the program
and the reference are handed them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.model import param_spec

_PHI_MINUS_2 = 0.5 * math.erfc(2.0 / math.sqrt(2.0))


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator on ``device`` for purpose ``tag`` of run ``seed``."""
    hi, lo = np.random.SeedSequence([seed, tag]).generate_state(2)
    gen = torch.Generator(device)
    gen.manual_seed(((int(hi) << 32) | int(lo)) & (2 ** 63 - 1))
    return gen


def truncated_normal(n: int, gen, device) -> torch.Tensor:
    """n unit normals truncated at +-2, by the inverse CDF of one uniform
    draw."""
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    u = _PHI_MINUS_2 + u * (1.0 - 2.0 * _PHI_MINUS_2)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


def make_weights(hp, seed: int, device, stop_bias: float = 0.0) -> dict:
    """{state-dict name: tensor} of every parameter and buffer;
    ``stop_bias`` fills the stop head's bias (the reference initialises it
    to 0; a synthesis mix sets -1e4 so that random weights never stop a
    row before its frame cap)."""
    spec = param_spec(hp)
    gen = generator(seed, 1, device)
    sizes = lambda kinds: sum(int(np.prod(s)) for _, s, k in spec
                              if k in kinds)
    trunc = truncated_normal(sizes(("dense", "half")), gen, device)
    normal = torch.randn(sizes(("normal",)), generator=gen, device=device)
    out, at_t, at_n = {}, 0, 0
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        if kind == "dense":
            fan_in = int(np.prod(shape[1:]))
            fan_out = shape[0] * int(np.prod(shape[2:]))
            std = math.sqrt(2.6 / ((fan_in + fan_out) / 2.0))
            t = trunc[at_t:at_t + n] * std
            at_t += n
        elif kind == "half":
            t = trunc[at_t:at_t + n] * 0.5
            at_t += n
        elif kind == "normal":
            t = normal[at_n:at_n + n]
            at_n += n
        elif kind == "count":
            t = torch.zeros((), dtype=torch.int64, device=device)
        else:
            value = {"zeros": 0.0, "ones": 1.0, "stop_bias": stop_bias}[kind]
            t = torch.full((n,), value, device=device)
        out[name] = t.reshape(shape).clone()
    return out
