"""The F5-TTS sampler (``hp.model == "f5tts"``): a batch of rows, each a
prompt mel, its text and a target text, integrated from noise to a mel by
the flow-matching ODE of ``models/f5tts.py``; F5's ``CFM.sample`` with
Euler steps.

Per row: the total frames follow F5's duration rule
(``f5_duration``: the prompt's frames plus the target's UTF-8 bytes at the
prompt's frames a byte; at least one frame past the longer of the prompt
and the text, at most the frame cap); the prompt mel conditions the
frames it covers; x_0 is unit noise over the row's frames.  The flow
times are ``flow_times``: ``hp.flow_nfe`` + 1 points i / nfe swayed by
t + s (cos(pi t / 2) - 1 + t), s = ``SWAY``.  In each Euler step
x += (t_{i+1} - t_i) v, the model runs once over every row twice: the
conditional half and the unconditional half (prompt mel zeroed, every text
id the filler); the guided velocity is v = v_c + ``CFG_STRENGTH`` (v_c -
v_u).  The pass runs on the rows' frames packed back to back
(``models/f5tts.py`` ``Packing``), so a call's work follows its rows'
lengths and no row pads another.  The text embedding of both halves and
the time modulation of every step do not depend on x_t and run once a
call.  The prompt's frames of the result are the prompt mel itself.

The state x (the rows' frames, packed) and the velocity are fp32; the
model computes in its dtype.

Spans (``utils/tracing.py``): ``synth.call`` (opened by
``synthesize_batch``) holds ``synth.prepare``, ``synth.weights``,
``synth.text``, ``synth.ode`` (one ``synth.ode_step`` a step, holding
its CFG pair) and ``synth.fetch``; counters ``synth.ode_steps`` and
``synth.generated_frames`` (frames past the prompt).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

from ..config import Config
from ..utils import tracing

CFG_STRENGTH = 2.0      # F5's published sampler: guidance 2, sway -1
SWAY = -1.0


def flow_times(nfe: int, sway: float, device=None) -> torch.Tensor:
    """[nfe + 1] fp32 flow times: i / nfe, then t + sway (cos(pi t / 2) -
    1 + t) (F5's sway sampling)."""
    t = torch.linspace(0.0, 1.0, nfe + 1, device=device,
                       dtype=torch.float32)
    return t + sway * (torch.cos(math.pi / 2 * t) - 1 + t)


def f5_duration(prompt_frames: int, prompt_bytes: int,
                target_bytes: int) -> int:
    """Total frames of a row: the prompt's plus
    floor(prompt frames / prompt bytes x target bytes) (F5's rule, on
    UTF-8 bytes)."""
    return int(prompt_frames) + int(prompt_frames / max(int(prompt_bytes), 1)
                                    * int(target_bytes))


def row_noise(durations, mels: int, generator: torch.Generator,
              device) -> torch.Tensor:
    """[B, max duration, mels] fp32: row i's unit normals over its
    ``durations[i]`` frames, drawn row after row, zero past them."""
    out = torch.zeros((len(durations), max(durations), mels),
                      device=device)
    for i, n in enumerate(durations):
        out[i, :n] = torch.randn((n, mels), generator=generator,
                                 device=device)
    return out


def f5_batch_inputs(batch: Dict[str, Any], hp: Config, cap: int):
    """Host arrays of a batch: (ids [B, L] int64, durations [B], prompt
    frames [B], prompt mels [B, T, mels] fp32 zero past each prompt).

    ``batch``: ``inputs`` [B, L] the prompt text's then the target text's
    UTF-8 bytes (-1 or anything past ``input_lengths``), ``input_lengths``
    [B], ``prompt_bytes`` [B], ``prompt_mels`` (a list of [n_i, mels]
    arrays or [B, T, mels] with ``prompt_lengths``), and optionally
    ``durations`` [B] in place of the rule."""
    ids = np.asarray(batch["inputs"]).astype(np.int64)
    lengths = np.asarray(batch["input_lengths"]).astype(np.int64)
    b = ids.shape[0]
    ids = np.where(np.arange(ids.shape[1])[None, :] < lengths[:, None], ids,
                   -1)
    prompts = batch["prompt_mels"]
    if "prompt_lengths" in batch:
        plen = np.asarray(batch["prompt_lengths"]).astype(np.int64)
        prompts = [np.asarray(prompts[i])[:plen[i]] for i in range(b)]
    else:
        prompts = [np.asarray(p) for p in prompts]
        plen = np.asarray([len(p) for p in prompts], np.int64)
    if batch.get("durations") is not None:
        dur = np.asarray(batch["durations"]).astype(np.int64)
    else:
        pbytes = np.asarray(batch["prompt_bytes"]).astype(np.int64)
        dur = np.asarray([f5_duration(plen[i], pbytes[i],
                                      lengths[i] - pbytes[i])
                          for i in range(b)], np.int64)
    # at least one frame past the prompt and the text (F5), at most the cap
    dur = np.minimum(np.maximum(dur, np.maximum(plen, lengths) + 1), cap)
    plen = np.minimum(plen, dur)
    cond = np.zeros((b, int(dur.max()), hp.num_mels), np.float32)
    for i in range(b):
        cond[i, :plen[i]] = prompts[i][:plen[i]]
    return ids, dur, plen, cond


class _Call:
    """A call's inputs on the device, packed (``Packing``: both CFG halves
    of every row), and what does not depend on x_t."""

    def __init__(self, model, batch, hp: Config, generator, max_frames):
        dev = model.device
        cap = int(max_frames or hp.max_generation_frames)
        ids, self.dur, self.plen, cond = f5_batch_inputs(batch, hp, cap)
        self.b, self.t = cond.shape[:2]
        t = self.t
        self.cond = torch.from_numpy(cond).to(dev)
        if batch.get("noise") is not None:
            x0 = torch.as_tensor(batch["noise"])[:, :t].to(dev,
                                                          torch.float32)
            x0 = F.pad(x0, (0, 0, 0, t - x0.shape[1]))
        else:
            if generator is None:
                generator = torch.Generator(dev)
                generator.seed()
            x0 = row_noise([int(n) for n in self.dur], hp.num_mels,
                           generator, dev)
        self.packing = p = model.packing(self.dur, 2, t)
        self.x0 = p.pack(x0)
        c = p.pack(self.cond)
        self.cond2 = torch.cat([c, torch.zeros_like(c)]).to(model.dtype)
        self.ids = torch.from_numpy(ids).to(dev)
        self.lengths = torch.from_numpy(self.dur).to(dev)
        self.times = flow_times(hp.flow_nfe, SWAY, dev)
        self.prompt = torch.arange(t, device=dev)[None, :] < \
            torch.from_numpy(self.plen).to(dev)[:, None]
        self.text2 = self.mods = None

    def embed(self, model):
        """Both halves' text and every step's modulation."""
        self.text2 = torch.cat([
            self.packing.pack(model.embed_text(self.ids, self.lengths,
                                               self.t, drop))
            for drop in (False, True)])
        self.mods = model.time_modulation(self.times[:-1])

    def velocity(self, model, x, i: int):
        """The guided velocity [R, mels] fp32 at the packed rows' state x
        [R, mels] and step i: one pass over the conditional and the
        unconditional halves."""
        v2 = model.velocity_packed(torch.cat([x, x]), self.cond2,
                                   self.text2, self.packing,
                                   [m[i] for m in self.mods])
        v_c, v_u = v2[:x.shape[0]], v2[x.shape[0]:]
        return v_c + CFG_STRENGTH * (v_c - v_u)


def sample(model, batch: Dict[str, Any], hp: Config,
           generator: Optional[torch.Generator] = None,
           max_frames: Optional[int] = None) -> Dict[str, Any]:
    """F5's CFG Euler sampler over ``batch`` (``f5_batch_inputs``) on the
    model's device.  x_0 is ``batch["noise"]`` ([B, T, mels], zero past
    each row; cut or zero-filled to the batch's T) when given, else
    ``row_noise`` from ``generator`` (a fresh randomly seeded one if
    None).  Returns the synthesis result dict: ``mel_aft`` = ``mel_pre``
    [B, T, mels] (numpy fp32), ``generated_lengths`` (each row's total
    frames), ``prompt_lengths``."""
    from .synthesize import matmul_weights_in
    with tracing.span("synth.prepare"):
        call = _Call(model, batch, hp, generator, max_frames)
    with matmul_weights_in(model, model.dtype), torch.no_grad():
        with tracing.span("synth.text"):
            call.embed(model)
        x, times = call.x0, call.times
        with tracing.span("synth.ode"):
            for i in range(hp.flow_nfe):
                with tracing.span("synth.ode_step"):
                    x = x + (times[i + 1] - times[i]) * \
                        call.velocity(model, x, i)
        out = torch.where(call.prompt[..., None], call.cond,
                          call.packing.unpack(x))
    tracing.count("synth.ode_steps", hp.flow_nfe)
    tracing.count("synth.generated_frames",
                  int((call.dur - call.plen).sum()))

    with tracing.span("synth.fetch"):
        mel = out.cpu().numpy()
    b = call.b
    return {"names": batch.get("names", [str(i) for i in range(b)]),
            "mel_pre": mel, "mel_aft": mel,
            "alignments": {"self": None, "encdec": None},
            "input_lengths": list(np.asarray(batch["input_lengths"])),
            "generated_lengths": [int(n) for n in call.dur],
            "prompt_lengths": [int(n) for n in call.plen]}


def guided_velocity(model, batch: Dict[str, Any], hp: Config, x, steps,
                    max_frames: Optional[int] = None) -> Dict[int, Any]:
    """{step: the guided velocity [B, T, mels] fp32} of ``batch`` at the
    states x [B, T, mels] (cut or zero-filled to the batch's T), as
    ``sample`` computes it at those steps (the same shapes and path); for
    checks."""
    from .synthesize import matmul_weights_in
    call = _Call(model, batch, hp, None, max_frames)
    x = torch.as_tensor(x)[:, :call.t].to(model.device, torch.float32)
    x = call.packing.pack(F.pad(x, (0, 0, 0, call.t - x.shape[1])))
    with matmul_weights_in(model, model.dtype), torch.no_grad():
        call.embed(model)
        return {i: call.packing.unpack(call.velocity(model, x, i))
                for i in steps}
