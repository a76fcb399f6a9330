"""The dropout masks of one training step, drawn from the step's seed.

The program draws each step's masks from one ``torch.Generator`` seeded
from (run seed, step): every elementwise dropout as ``torch.rand(shape) <
keep`` in the order the forward meets them, and every attention layer one
int64 seed (``torch.randint(0, 2**62)``), from which its kernel derives the
mask of each (row, head, query, key) by Philox-4x32-10 (``philox.py``).  On
the CPU the program's attention takes its plain path, which draws the
weights' mask with ``torch.rand`` too.  ``DropPlan`` replays that sequence
for the whole padded batch, so the reference applies the masks the program
applied; ``DropPlan.rows`` serves a block of rows of them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import philox
from .model import postnet_channels


def step_seed(seed: int, step: int) -> int:
    """The generator seed of a training step: SeedSequence([seed, step])'s
    first two words, as one 63-bit number."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


def generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device)
    gen.manual_seed(step_seed(seed, step))
    return gen


class DropPlan:
    """The masks of one step for a padded batch of ``b`` rows, ``t_in``
    input and ``t_out`` target positions."""

    def __init__(self, hp, b, t_in, t_out, gen, device, attn_mode):
        self.attn_mode = attn_mode
        self.masks = {}
        heads = hp.n_attention_head
        rt, rd = hp.transformer_dropout_rate, hp.decoder_dropout_rate

        def el(name, shape, rate):
            if rate > 0:
                self.masks[name] = torch.rand(
                    shape, generator=gen, device=device) < 1.0 - rate

        def at(name, tq, tk, rate):
            if rate <= 0:
                return
            if attn_mode == "philox":
                self.masks[name] = torch.randint(
                    0, 2 ** 62, (1,), generator=gen, device=device,
                    dtype=torch.int64)
            else:
                self.masks[name] = torch.rand(
                    (b, heads, tq, tk), generator=gen, device=device) < \
                    1.0 - rate

        e, he, hd = hp.embed_size, hp.encoder_hidden, hp.decoder_hidden
        el("enc.pe", (b, t_in, e), rt)
        for i in range(hp.n_encoder_layer):
            width = e if i == 0 else he
            at("enc.%d.attn" % i, t_in, t_in, rt)
            el("enc.%d.attn_out" % i, (b, t_in, width), rt)
            el("enc.%d.ffn_hidden" % i, (b, t_in, 4 * he), rt)
            el("enc.%d.ffn_out" % i, (b, t_in, he), rt)
        el("dec.prenet0", (b, t_out, hp.prenet_hidden), rd)
        el("dec.prenet1", (b, t_out, hp.prenet_hidden), rd)
        el("dec.pe", (b, t_out, hd), rt)
        for i in range(hp.n_decoder_layer):
            at("dec.%d.self" % i, t_out, t_out, rt)
            el("dec.%d.self_out" % i, (b, t_out, hd), rt)
            at("dec.%d.cross" % i, t_out, t_in, rt)
            el("dec.%d.cross_out" % i, (b, t_out, hd), rt)
            el("dec.%d.ffn_hidden" % i, (b, t_out, 4 * hd), rt)
            el("dec.%d.ffn_out" % i, (b, t_out, hd), rt)
        for i, (_, c_out) in enumerate(postnet_channels(hp)):
            el("post.%d" % i, (b, t_out, c_out), rd)

    def rows(self, r0: int, r1: int) -> "RowMasks":
        return RowMasks(self, r0, r1)


class RowMasks:
    """The masks of rows [r0, r1) of a DropPlan."""

    def __init__(self, plan, r0, r1):
        self.plan, self.r0, self.r1 = plan, r0, r1

    def apply(self, name, x, rate):
        mask = self.plan.masks.get(name)
        if mask is None or rate <= 0:
            return x
        keep = mask[self.r0:self.r1]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(keep, x / (1.0 - rate), zero)

    def attn(self, name, w, rate):
        mask = self.plan.masks.get(name)
        if mask is None or rate <= 0:
            return w
        if self.plan.attn_mode == "philox":
            b, h, tq, tk = w.shape
            keep = philox.keep_mask(mask, self.r0, b, h, tq, tk, rate)
        else:
            keep = mask[self.r0:self.r1]
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        return torch.where(keep, w / (1.0 - rate), zero)
