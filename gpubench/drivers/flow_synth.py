"""Zero-shot voice cloning with F5-TTS, offline and closed loop: one
``synthesize_batch`` call after another on the mix's batches
(``flow_traffic.py``: a prompt mel, its text and a target text a row, the
noise x_0 from the seed), each the configuration's CFG Euler sampler over
whole rows.  Outputs are mels; no vocoder.

The check samples rows of the calls the window completed, the longest
always among them, and runs the reference (``reference/f5tts.py``, float32,
one row at a time) from the same x_0:
  mel_gap        relative L2, over the frames past the prompt, of the
                 program's mel against the reference's ODE solution
  velocity_gap   relative L2 of the program's guided velocity against the
                 reference's at steps ``velocity_steps`` of the reference's
                 own trajectory, the program's computed on the call's
                 whole batch (the timed shapes) with the row's state in
                 its place; the worst step
  prompt_faults  prompt frames of any row of any call not equal to the
                 prompt (limit 0)
  length_faults  rows of any call whose frames differ from the duration
                 rule (limit 0)
The control (``variants``: "fp8") is the reference with float8 e4m3
products against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import compare, f5counts, flow_traffic
from ..readers import Readings
from ..reference import f5tts as ref
from ..reference.model import exact, fp8
from .common import Outcome, Phases, now, sample_indices


def prebuild_f5(ctx):
    """Build the attention forward at F5's head dim (``common.prebuild``
    knows the byte2speech widths only)."""
    if ctx.device.type != "cuda" or not ctx.hp.use_pallas_attention:
        return
    from few_shot_transformer_tts_torch.ops import cuda_build
    from few_shot_transformer_tts_torch.ops.mha import kernel_head_dim
    d = kernel_head_dim(ctx.hp.dit_dim // ctx.hp.dit_heads)
    if d > cuda_build.HEAD_DIMS[-1]:
        cuda_build.build("mha_wide", None)
    else:
        cuda_build.build("mha_fwd", d)


class Driver:

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.cell.mix

    def setup(self):
        from few_shot_transformer_tts_torch.infer.synthesize import \
            synthesize_batch
        from few_shot_transformer_tts_torch.models.f5tts import F5TTS
        ctx = self.ctx
        self.phases = phases = Phases()
        self.batches = flow_traffic.flow_batches(
            self.mix, ctx.ref_hp, ctx.seed, self.mix["batches"], ctx.device)
        phases.mark("traffic")
        prebuild_f5(ctx)
        phases.mark("build")
        self.model = F5TTS(ctx.hp, device=ctx.device).eval()
        self.model.load_state_dict(self.weights(), strict=True)
        self.synthesize = synthesize_batch
        phases.mark("model")
        # the longest call warms the kernels and the allocator
        self._call(max(self.batches, key=lambda b: b["noise"].shape[1]))
        phases.mark("warm")

    def weights(self):
        return ref.make_weights(self.ctx.ref_hp, self.ctx.seed,
                                self.ctx.device)

    def _call(self, batch):
        return self.synthesize(self.model, batch, self.ctx.hp,
                               max_frames=self.mix["max_frames"])

    def window(self, seconds, tracer) -> Outcome:
        ctx, dev, hp = self.ctx, self.ctx.device, self.ctx.ref_hp
        traced = self.mix["traced_calls"] if tracer.enabled else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.outputs, units, trace, t_traced = [], [], None, None
        setup_s = now() - ctx.t_start
        if traced:
            tracer.start()
        t0 = now()
        deadline = t0 + seconds
        while True:
            i = len(units)
            bi = i % len(self.batches)
            with tracer.span("synthesize_batch"):
                out = self._call(self.batches[bi])
            lengths = [int(n) for n in out["generated_lengths"]]
            prompts = [int(n) for n in out["prompt_lengths"]]
            units.append({"frames": sum(lengths) - sum(prompts),
                          "flops": sum(f5counts.sample_row_flops(hp, n)
                                       for n in lengths)})
            self.outputs.append((bi, out))
            if traced and trace is None and len(units) == traced:
                trace = tracer.stop(traced)
                t_traced = now()
                deadline += tracer.stop_s    # reading the trace is no work
            if now() >= deadline:
                break
        t1 = now()
        if traced and trace is None:
            trace = tracer.stop(len(units))
            t_traced = t1
        rest = units[traced:]
        readings = Readings(
            units=len(units), counts={"calls": len(units)},
            untraced_flops=sum(u["flops"] for u in rest),
            untraced_s=(t1 - (t_traced or t0)) if rest else 0.0,
            peak_bytes=torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0,
            trace=trace)
        frames = sum(u["frames"] for u in units)
        e2e = {"synth_audio_s_per_s":
               frames * hp.hop_length / hp.sr / (t1 - t0),
               "setup_s": setup_s}
        return Outcome(e2e, readings, attempted=len(units), failed=0,
                       trace=trace,
                       notes={"calls": len(units), "window_s": t1 - t0,
                              "setup_phases_s": self.phases.seconds})

    # ------------------------------------------------------------------
    def _faults(self):
        """(prompt frames not the prompt, rows off the duration rule) over
        every row of every call."""
        prompt_faults = length_faults = 0
        for bi, out in self.outputs:
            batch = self.batches[bi]
            for r, want in enumerate(batch["durations_expected"]):
                length_faults += int(out["generated_lengths"][r]) != want
                p = batch["prompt_mels"][r]
                got = out["mel_aft"][r][:len(p)]
                prompt_faults += int(np.sum(np.any(got != p, axis=-1))) + \
                    max(0, len(p) - len(got))
        return prompt_faults, length_faults

    def _row(self, bi, r):
        """(frames, prompt frames, x_0, prompt, ids) of row r of batch bi."""
        batch, dev = self.batches[bi], self.ctx.device
        n = batch["durations_expected"][r]
        prompt = torch.from_numpy(batch["prompt_mels"][r]).to(dev)
        ids = batch["inputs"][r][:int(batch["input_lengths"][r])].tolist()
        return n, len(prompt), batch["noise"][r, :n], prompt, ids

    def _program_velocity_gaps(self, bi, r, states):
        """The program's guided velocity at the reference's states, on the
        call's whole batch, against the reference's."""
        from few_shot_transformer_tts_torch.infer.flow import \
            guided_velocity
        batch = self.batches[bi]
        n = batch["durations_expected"][r]
        gaps = []
        for i, (x_i, v_ref) in states.items():
            x = batch["noise"].clone()
            x[r, :n] = x_i
            v = guided_velocity(self.model, batch, self.ctx.hp, x, (i,),
                                self.mix["max_frames"])[i]
            gaps.append(compare.rel_l2(v[r, :n].cpu(), v_ref.cpu()))
        return gaps

    def check(self, variants=()):
        ctx, hp = self.ctx, self.ctx.ref_hp
        rows = [(c, r) for c, (_, out) in enumerate(self.outputs)
                for r in range(len(out["generated_lengths"]))]
        size = lambda cr: self.batches[self.outputs[cr[0]][0]][
            "durations_expected"][cr[1]]
        longest = max(range(len(rows)), key=lambda i: size(rows[i]))
        picked = [rows[i] for i in sample_indices(
            len(rows), self.mix["sample_rows"], longest, ctx.seed, 21)]
        prompt_faults, length_faults = self._faults()
        times = ref.flow_times(hp.flow_nfe, ref.SWAY)
        keep = tuple(self.mix["velocity_steps"])
        mel_gaps, vel_gaps = [], []
        control = {v: ([], []) for v in variants}
        with ref.no_tf32(), torch.no_grad():
            P = self.weights()
            for c, r in picked:
                bi, out = self.outputs[c]
                n, p, x0, prompt, ids = self._row(bi, r)
                mel, states = ref.sample(P, hp, x0, prompt, ids, exact, keep)
                got = np.zeros((n - p, hp.num_mels), np.float32)
                have = out["mel_aft"][r][p:n]     # short if its length is
                got[:len(have)] = have            # off the rule
                mel_gaps.append(compare.rel_l2(got, mel[p:n].cpu()))
                vel_gaps.append(max(self._program_velocity_gaps(bi, r,
                                                                states)))
                for v in variants:     # the control: the reference in fp8
                    low, _ = ref.sample(P, hp, x0, prompt, ids, fp8)
                    cond = ref.prompt_cond(prompt, n)
                    control[v][0].append(compare.rel_l2(low[p:n].cpu(),
                                                        mel[p:n].cpu()))
                    control[v][1].append(max(compare.rel_l2(
                        ref.cfg_velocity(P, hp, x_i, cond, ids, times[i],
                                         fp8).cpu(), v_i.cpu())
                        for i, (x_i, v_i) in states.items()))
        nums = {"mel_gap": max(mel_gaps), "velocity_gap": max(vel_gaps),
                "prompt_faults": prompt_faults,
                "length_faults": length_faults}
        notes = {"sampled_rows": len(picked),
                 "sampled_frames": [size(cr) for cr in picked],
                 "mel_gaps": mel_gaps, "velocity_gaps": vel_gaps}
        extra = {v: {"mel_gap": max(a), "velocity_gap": max(b),
                     "prompt_faults": 0, "length_faults": 0}
                 for v, (a, b) in control.items()}
        self.model = None
        return nums, notes, extra
