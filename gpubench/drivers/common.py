"""What the drivers share: the run's context, the program's model with the
benchmark's weights, the kernels built ahead, and the outcome of a run."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..reference import model as ref_model
from ..readers import Readings
from ..weights import make_weights


@dataclass
class Context:
    cell: object                 # spec.Cell
    seed: int
    device: torch.device
    workdir: str                 # under TMPDIR; removed at exit
    t_start: float               # perf_counter at process start
    hp: object = None            # the program's Config
    ref_hp: object = None        # the same values for the reference

    def __post_init__(self):
        from few_shot_transformer_tts_torch.config import Config
        values = self.cell.hparams
        self.hp = Config(**values)
        self.ref_hp = ref_model.hparams(values)


@dataclass
class Outcome:
    e2e: dict                    # end-to-end metric name -> value
    readings: Readings
    attempted: int
    failed: int
    checks: dict = field(default_factory=dict)     # number -> value
    notes: dict = field(default_factory=dict)      # shown on stderr
    trace: Optional[object] = None


def program_model(ctx: Context, weights: dict):
    """The program's ``ByteToMel`` on the run's device holding ``weights``
    (the state dict must match name for name)."""
    from few_shot_transformer_tts_torch.models.tacotron import ByteToMel
    model = ByteToMel(ctx.hp, device=ctx.device)
    model.load_state_dict(weights, strict=True)
    return model


def prebuild(ctx: Context, train: bool):
    """Build the kernel libraries this cell's path loads, in parallel
    (a checkout's first run; later runs find them built)."""
    if ctx.device.type != "cuda":
        return
    from few_shot_transformer_tts_torch.ops import cuda_build
    from few_shot_transformer_tts_torch.ops.mha import kernel_head_dim
    hp = ctx.hp
    jobs = set()
    if hp.use_pallas_attention:
        dims = {kernel_head_dim(hp.encoder_hidden // hp.n_attention_head)}
        if train:
            dims.add(kernel_head_dim(hp.decoder_hidden // hp.n_attention_head))
        for d in dims:
            for name in ("mha_fwd", "mha_bwd") if train else ("mha_fwd",):
                if d > cuda_build.HEAD_DIMS[-1]:
                    jobs.add(("mha_wide", None))
                else:
                    jobs.add((name, d))
    if train and hp.use_fused_layernorm:
        jobs.add(("layernorm_bwd", None))
    if train and hp.use_fused_adam:
        jobs.add(("fused_adam", None))
    if not train and hp.use_pallas_decode:
        jobs.add(("decoder_step", None))
    errors = []

    def build(job):
        try:
            cuda_build.build(*job)
        except Exception as e:      # surfaces below, after every build
            errors.append(e)
    threads = [threading.Thread(target=build, args=(j,)) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now():
    return time.perf_counter()


def weights_for(ctx: Context) -> dict:
    return make_weights(ctx.ref_hp, ctx.seed, ctx.device,
                        ctx.cell.mix.get("stop_bias", 0.0))


class Phases:
    """Seconds of each named stretch of set-up, for the notes."""

    def __init__(self):
        self.seconds, self._t = {}, now()

    def mark(self, name):
        t = now()
        self.seconds[name] = t - self._t
        self._t = t


def sample_indices(n: int, k: int, longest: int, seed: int, tag: int):
    """k of n indices drawn from the seed, ``longest`` among them."""
    rng = np.random.default_rng([seed, tag])
    rest = [i for i in rng.permutation(n) if i != longest]
    return sorted([longest] + rest[:max(0, k - 1)])
