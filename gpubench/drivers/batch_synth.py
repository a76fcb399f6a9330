"""Offline batch synthesis, closed loop: one ``synthesize_batch`` call after
another on batches of the mix's rows, each decoded to the mix's frame cap
with the mix's decode path (``hparams``; the fused decode step with
``use_pallas_decode``), deterministic, without alignments.  Outputs are
mels.  The check samples rows of the calls the window completed."""

from __future__ import annotations

import torch

from .. import counts, traffic
from ..readers import Readings
from . import decoding
from .common import (Outcome, Phases, now, prebuild, program_model,
                     sample_indices, weights_for)


class Driver:

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.cell.mix

    def setup(self):
        from few_shot_transformer_tts_torch.infer.synthesize import \
            synthesize_batch
        ctx = self.ctx
        self.phases = phases = Phases()
        self.batches = traffic.synth_batches(self.mix, ctx.ref_hp, ctx.seed,
                                             self.mix["batches"])
        phases.mark("traffic")
        prebuild(ctx, train=False)
        phases.mark("build")
        self.model = program_model(ctx, weights_for(ctx)).eval()
        self.synthesize = synthesize_batch
        phases.mark("model")
        # every call has the same shapes: one call warms them all
        self._call(self.batches[-1])
        phases.mark("warm")

    def _call(self, batch):
        return self.synthesize(self.model, batch, self.ctx.hp,
                               deterministic=True, collect_alignments=False,
                               max_frames=self.mix["max_frames"])

    def window(self, seconds, tracer) -> Outcome:
        ctx, dev = self.ctx, self.ctx.device
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
            batch = self.batches[i % len(self.batches)]
            with tracer.span("synthesize_batch"):
                out = self._call(batch)
            steps = out["mel_pre"].shape[1]
            lengths = [min(int(g), steps) for g in out["generated_lengths"]]
            units.append({"frames": sum(lengths), "steps": steps,
                          "flops": sum(counts.decode_row_flops(
                              ctx.ref_hp, int(batch["input_lengths"][r]), n)
                              for r, n in enumerate(lengths))})
            self.outputs.append((i % len(self.batches), out))
            if traced and trace is None and len(units) == traced:
                trace = tracer.stop(traced)
                trace.extra["frame_steps"] = sum(u["steps"] for u in units)
                t_traced = now()
                deadline += tracer.stop_s    # reading the trace is no work
            if now() >= deadline:
                break
        t1 = now()
        if traced and trace is None:
            trace = tracer.stop(len(units))
            trace.extra["frame_steps"] = sum(u["steps"] for u in units)
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
               frames * ctx.hp.frame_shift_ms / 1000.0 / (t1 - t0),
               "setup_s": setup_s}
        self.model = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return Outcome(e2e, readings, attempted=len(units), failed=0,
                       trace=trace,
                       notes={"calls": len(units), "window_s": t1 - t0,
                              "setup_phases_s": self.phases.seconds})

    def check(self, variants=()):
        ctx, dev = self.ctx, self.ctx.device
        rows = [(c, r) for c, (_, out) in enumerate(self.outputs)
                for r in range(len(out["generated_lengths"]))]
        size = lambda cr: int(self.batches[self.outputs[cr[0]][0]]
                              ["input_lengths"][cr[1]])
        longest = max(range(len(rows)), key=lambda i: size(rows[i]))
        picked = [rows[i] for i in sample_indices(
            len(rows), self.mix["sample_rows"], longest, ctx.seed, 6)]
        P = weights_for(ctx)
        results = {v: [] for v in ("exact",) + tuple(variants)}
        for c, r in picked:
            bi, out = self.outputs[c]
            args = (P, ctx.ref_hp, self.batches[bi], r, out["mel_pre"][r],
                    out["mel_aft"][r], out["generated_lengths"][r],
                    self.mix["max_frames"], dev)
            results["exact"].append(decoding.judge_row(*args))
        for v in variants:   # the control: what the reference in fp8 reads
            for c, r in picked:
                bi, out = self.outputs[c]
                results[v].append(decoding.control_row(
                    P, ctx.ref_hp, self.batches[bi], r, out["mel_pre"][r],
                    dev))
        nums = decoding.worst(results["exact"])
        notes = {"sampled_rows": len(picked),
                 "frame_l2": nums.pop("frame_l2"),
                 "postnet_l2": nums.pop("postnet_l2")}
        extra = {v: decoding.worst(results[v]) for v in variants}
        return nums, notes, extra
