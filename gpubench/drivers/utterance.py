"""One client, closed loop, one utterance a request: ``synthesize_batch`` of
one row to the request's frame cap on the mix's decode path, then
``vocode_batch`` (Griffin-Lim on the card) of its mel; a request runs from
its text bytes on the host to its waveform on the host.  Its real-time
factor is that wall time over the waveform's seconds.  The check samples
requests the window completed: their frames against the reference's
decoder, and their Griffin-Lim waveforms against the spectrum the mel asks
for (``reference/vocoder.py``)."""

from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

from .. import counts, traffic
from ..readers import Readings
from ..reference import vocoder as ref_vocoder
from . import decoding
from .common import (Outcome, Phases, now, prebuild, program_model,
                     sample_indices, weights_for)


class Driver:

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.cell.mix

    def setup(self):
        from few_shot_transformer_tts_torch.infer.synthesize import (
            synthesize_batch, vocode_batch)
        ctx, dev = self.ctx, self.ctx.device
        self.phases = phases = Phases()
        self.requests = traffic.utterances(self.mix, ctx.ref_hp, ctx.seed,
                                           self.mix["requests"])
        phases.mark("traffic")
        prebuild(ctx, train=False)
        phases.mark("build")
        self.model = program_model(ctx, weights_for(ctx)).eval()
        self.synthesize, self.vocode = synthesize_batch, vocode_batch
        phases.mark("model")
        # one request of each padded text length, and the vocoder at every
        # frame count the mix can ask for (cuFFT plans are per length)
        seen = {}
        for batch, cap in self.requests:
            key = -(-batch["inputs"].shape[1] // ctx.hp.input_length_multiple)
            seen.setdefault(key, (batch, cap))
        for batch, cap in seen.values():
            self._request(batch, cap)
        phases.mark("warm_requests")
        lo, hi = self.mix["input_bytes"]
        caps = sorted({traffic.frame_cap(n, self.mix)
                       for n in range(lo, hi + 1)})
        for cap in caps:
            mel = np.zeros((1, cap, ctx.hp.num_mels), np.float32)
            self.vocode(mel, [cap + 1], ctx.hp, dev)
        phases.mark("warm_vocoder")

    def _request(self, batch, cap, tracer=None):
        out = self.synthesize(self.model, batch, self.ctx.hp,
                              deterministic=True, collect_alignments=False,
                              max_frames=cap)
        entry = tracer.entry("vocode_batch") if tracer else \
            contextlib.nullcontext()
        with entry:
            wav = self.vocode(out["mel_aft"], out["generated_lengths"],
                              self.ctx.hp, self.ctx.device)[0]
        return out, wav

    def window(self, seconds, tracer) -> Outcome:
        ctx, dev, hp = self.ctx, self.ctx.device, self.ctx.hp
        traced = self.mix["traced_requests"] if tracer.enabled else 0
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
            batch, cap = self.requests[i % len(self.requests)]
            ta = now()
            with tracer.span("request"):
                out, wav = self._request(batch, cap, tracer)
            wall = now() - ta
            audio_s = len(wav) / hp.sr
            steps = out["mel_pre"].shape[1]
            n = min(int(out["generated_lengths"][0]), steps)
            units.append({"rtf": wall / audio_s if audio_s > 0
                          else float("inf"), "steps": steps,
                          "flops": counts.decode_row_flops(
                              ctx.ref_hp, int(batch["input_lengths"][0]), n)})
            self.outputs.append((i % len(self.requests), out, wav))
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
            t_traced = t1
        rest = units[traced:]
        rtf = [u["rtf"] for u in units]
        readings = Readings(
            units=len(units), counts={"requests": len(units)},
            untraced_flops=sum(u["flops"] for u in rest),
            untraced_s=(t1 - (t_traced or t0)) if rest else 0.0,
            peak_bytes=torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0,
            trace=trace)
        e2e = {"utt_rtf_p90": p90(rtf), "setup_s": setup_s}
        self.model = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return Outcome(e2e, readings, attempted=len(units), failed=0,
                       trace=trace,
                       notes={"requests": len(units), "window_s": t1 - t0,
                              "rtf_median": statistics.median(rtf),
                              "setup_phases_s": self.phases.seconds})

    def check(self, variants=()):
        """The sampled requests' numbers; with ``variants`` also the
        control's ("fp8": the decode's products in float8 and the vocoder's
        float64 Griffin-Lim rounded to bf16) and, for "vocoder_faults",
        what the planted vocoder faults read (``reference/vocoder.py``)."""
        ctx, dev = self.ctx, self.ctx.device
        caps = [self.requests[i][1] for i, _, _ in self.outputs]
        longest = max(range(len(caps)), key=caps.__getitem__)
        picked = sample_indices(len(caps), self.mix["sample_requests"],
                                longest, ctx.seed, 7)
        P = weights_for(ctx)
        wave_variants = (("bf16",) if "fp8" in variants else ()) + \
            (VOCODER_FAULTS if "vocoder_faults" in variants else ())
        rows, extra = [], {v: [] for v in variants}
        for k in picked:
            i, out, wav = self.outputs[k]
            batch, cap = self.requests[i]
            row = decoding.judge_row(
                P, ctx.ref_hp, batch, 0, out["mel_pre"][0],
                out["mel_aft"][0], out["generated_lengths"][0], cap, dev)
            waves, faults = ref_vocoder.judge_wave(
                wav, np.asarray(out["mel_aft"][0]),
                out["generated_lengths"][0], ctx.ref_hp, dev, wave_variants)
            rows.append({**row, **waves})
            if "fp8" in variants:
                extra["fp8"].append({
                    **decoding.control_row(P, ctx.ref_hp, batch, 0,
                                           out["mel_pre"][0], dev),
                    **faults["bf16"]})
            if "vocoder_faults" in variants:
                extra["vocoder_faults"].append(
                    {"%s.%s" % (f, n): v for f in VOCODER_FAULTS
                     for n, v in faults[f].items()})
        nums = decoding.worst(rows)
        notes = {"sampled_requests": len(picked),
                 "frame_l2": nums.pop("frame_l2"),
                 "postnet_l2": nums.pop("postnet_l2")}
        controls = {v: decoding.worst(r) for v, r in extra.items()}
        return nums, notes, controls


VOCODER_FAULTS = ("unchanged", "no_deemphasis", "quarter_lost")


def p90(values) -> float:
    """The 90th percentile (linear between order statistics)."""
    if len(values) < 2:
        return float(values[0]) if values else float("inf")
    return statistics.quantiles(values, n=10, method="inclusive")[-1]

