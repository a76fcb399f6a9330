"""Training, closed loop: the program's ``Feeder`` thread reads a packed
corpus written from the seed (its native zip reader, language balancing,
sorted buckets, greedy packing under the mix's budgets), and each step is
``device_batch`` then ``train_step`` (forward with dropout, loss, backward
through the attention and LayerNorm kernels, Adam), the next batch fetched
while the card runs the step, as the program's training loop does.

Set-up builds one model and optimizer and drives them through the mix's
``compared_steps`` first steps by that same call and feed; the window
continues them.  Nothing in either waits for the card between steps: what
the check reads stays on the card until the window has closed.  The check
follows the first steps from the seed (their losses, the first gradient
from Adam's first moment after one step, the parameters' change, each
packed batch worked out again from the corpus), and one step of the window
(drawn from the seed in ``checked_window_step``) from the program's own
state, copied on the card before that step: its loss, its gradient, its
Adam update and its batch.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import compare, counts, traffic
from ..readers import Readings
from ..reference import dropout as ref_dropout
from ..reference import model as ref_model
from ..reference.batch import Corpus, batch_faults, padded_batch
from ..reference.train import Adam, step_grads
from .common import (Outcome, Phases, now, prebuild, program_model,
                     sync, weights_for)


class Driver:

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.cell.mix

    # ------------------------------------------------------------------
    def setup(self):
        from few_shot_transformer_tts_torch.data.feeder import Feeder
        from few_shot_transformer_tts_torch.train.loop import (
            device_batch, make_optimizer, step_generator, train_step)
        ctx, hp, dev = self.ctx, self.ctx.hp, self.ctx.device
        self.phases = phases = Phases()
        self.device_batch, self.train_step = device_batch, train_step
        self.step_generator = step_generator
        root = traffic.write_corpus(self.mix, ctx.ref_hp, ctx.seed,
                                    os.path.join(ctx.workdir, "corpus"), dev)
        self.corpus_dir = root
        phases.mark("corpus")
        prebuild(ctx, train=True)
        phases.mark("build")
        weights = weights_for(ctx)
        self.model = program_model(ctx, weights)
        self.optimizer, self.scheduler = make_optimizer(self.model, hp)
        maps = {}
        for key, fname in (("spk_to_id", "spk_id.json"),
                           ("lang_to_id", "lang_id.json")):
            with open(os.path.join(root, fname)) as f:
                maps[key] = json.load(f)
        self.feeder = Feeder(os.path.join(root, "mels.zip"),
                             os.path.join(root, "metadata.train.txt"),
                             hparams=hp, **maps)
        self.feeder.start()
        self.step = 0
        self.compared = []
        start = {n: weights[n] for n, _ in self.model.named_parameters()}
        phases.mark("model")
        host = self.feeder.get_batch()
        db = device_batch(host, hp, dev)
        phases.mark("first_batch")
        for k in range(self.mix["compared_steps"]):
            out = self._step(db)
            rec = {"names": list(host["names"]), "loss": out["loss"],
                   "batch": db}
            if k == 0:
                rec["grads"] = self._first_gradient_norms()
            self.compared.append(rec)
            host = self.feeder.get_batch()
            db = device_batch(host, hp, dev)
        with torch.no_grad():
            self.updates = {n: (p - start[n]).norm()
                            for n, p in self.model.named_parameters()}
        lo, hi = self.mix["checked_window_step"]
        self.checked_step = int(np.random.default_rng([ctx.seed, 11])
                                .integers(lo, hi + 1))
        self.checked = None
        del weights, start
        self.host, self.db = host, db
        sync(dev)
        phases.mark("compared_steps")

    def _step(self, db):
        ctx = self.ctx
        out = self.train_step(self.model, self.optimizer, self.scheduler, db,
                              ctx.hp, self.step_generator(ctx.seed, self.step,
                                                          ctx.device))
        self.step += 1
        return out

    def _first_gradient_norms(self):
        """The first gradient's norm per leaf (on the card), from Adam's
        first moment after one step: exp_avg = (1 - beta1) g."""
        beta1 = self.ctx.hp.adam_beta1
        out = {}
        for n, p in self.model.named_parameters():
            m = self.optimizer.state.get(p, {}).get("exp_avg")
            out[n] = 0.0 if m is None else m.norm() / (1 - beta1)
        return out

    @torch.no_grad()
    def _state_copy(self):
        """The parameters and Adam's moments, copied on the card (queued
        behind the step before; the host does not wait)."""
        params, m, v = {}, {}, {}
        for n, p in self.model.named_parameters():
            params[n] = p.detach().clone()
            state = self.optimizer.state.get(p, {})
            if "exp_avg" in state:
                m[n] = state["exp_avg"].clone()
                v[n] = state["exp_avg_sq"].clone()
        return {"params": params, "exp_avg": m, "exp_avg_sq": v,
                "step": self.step}

    @torch.no_grad()
    def _step_result(self, before, out, host, db):
        """What the checked window step did: its loss, its gradient and the
        parameters' change, on the card."""
        grads, change = {}, {}
        for n, p in self.model.named_parameters():
            grads[n] = p.grad.norm() if p.grad is not None else \
                torch.zeros((), device=p.device)
            change[n] = (p.detach() - before["params"][n]).norm()
        return {"before": before, "loss": out["loss"], "grads": grads,
                "updates": change, "names": list(host["names"]),
                "batch": db}

    def _unit(self, host):
        tl = np.asarray(host["target_lengths"])
        il = np.asarray(host["input_lengths"])
        n = host["num_valid"]
        flops = sum(counts.train_row_flops(self.ctx.ref_hp, int(il[i]),
                                           int(tl[i])) for i in range(n))
        return {"frames": int(tl.sum()), "flops": flops,
                "batch_frames": int(host["mel_targets"].shape[0] *
                                    host["mel_targets"].shape[1])}

    # ------------------------------------------------------------------
    def window(self, seconds, tracer) -> Outcome:
        """Steps until ``seconds`` have passed (and the checked step is
        done).  With tracing, steps ``trace_after_steps`` to that plus
        ``traced_steps`` are traced: a stretch from inside the window, the
        queue already full."""
        ctx, hp, dev = self.ctx, self.ctx.hp, self.ctx.device
        traced = self.mix["traced_steps"] if tracer.enabled else 0
        first = self.mix["trace_after_steps"]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        units, wait, trace = [], 0.0, None
        t_trace = [0.0, 0.0]
        host, db = self.host, self.db
        setup_s = now() - ctx.t_start
        t0 = now()
        deadline = t0 + seconds
        while True:
            i = len(units)
            if traced and i == first:
                tracer.start()
                t_trace[0] = now()
            before = self._state_copy() if i == self.checked_step else None
            with tracer.span("train_step"):
                out = self._step(db)
            if before is not None:
                self.checked = self._step_result(before, out, host, db)
                self.checked["window_step"] = i
            units.append(self._unit(host))
            if traced and len(units) == first + traced:
                trace = tracer.stop(traced)
                trace.extra["steps"] = traced
                t_trace[1] = now()
                deadline += tracer.stop_s    # reading the trace is no work
            if now() >= deadline and self.checked is not None:
                break
            t = now()
            with tracer.span("feeder_wait"):
                host = self.feeder.get_batch()
            wait += now() - t
            with tracer.span("device_batch"):
                db = self.device_batch(host, hp, dev)
        sync(dev)
        t1 = now()
        if tracer.active:
            trace = tracer.stop(len(units) - first)
            trace.extra["steps"] = len(units) - first
            t_trace[1] = t1
        rest = units[:first] + units[first + traced:] if trace else units
        frames = sum(u["frames"] for u in units)
        readings = Readings(
            units=len(units),
            counts={"steps": len(units), "feeder_wait_s": wait,
                    "padded_frames": sum(u["batch_frames"] - u["frames"]
                                         for u in units),
                    "batch_frames": sum(u["batch_frames"] for u in units)},
            untraced_flops=sum(u["flops"] for u in rest),
            untraced_s=(t1 - t0) - (t_trace[1] - t_trace[0]),
            peak_bytes=torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else 0,
            trace=trace)
        e2e = {"train_audio_s_per_s":
               frames * hp.frame_shift_ms / 1000.0 / (t1 - t0),
               "setup_s": setup_s}
        self.model = self.optimizer = self.scheduler = None
        self.host = self.db = host = db = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return Outcome(e2e, readings, attempted=len(units), failed=0,
                       trace=trace,
                       notes={"steps": len(units), "window_s": t1 - t0,
                              "checked_window_step": self.checked_step,
                              "setup_phases_s": self.phases.seconds})

    # ------------------------------------------------------------------
    def _reference_step(self, P, adam, corpus, names, step, Q, half,
                        budget):
        """One reference step of ``P`` over the batch of ``names``, as the
        program's step ``step`` (its dropout masks): (loss, gradient norms,
        the expected host batch)."""
        ctx, dev, hp = self.ctx, self.ctx.device, self.ctx.ref_hp
        attn = "philox" if dev.type == "cuda" and \
            ctx.hp.use_pallas_attention else "torch"
        want = padded_batch(corpus, names, hp)
        expected = {k: v.copy() for k, v in want.items()}
        if half:
            want["target_lengths"][1::2] = 0
        batch = {key: torch.from_numpy(v).to(dev) for key, v in want.items()}
        b, t_in = want["inputs"].shape
        plan = ref_dropout.DropPlan(
            hp, b, t_in, want["mel_targets"].shape[1],
            ref_dropout.generator(ctx.seed, step, dev), dev, attn)
        loss = step_grads(P, hp, batch, plan, Q, budget=budget)["loss"]
        grads = {n: float(p.grad.norm()) for n, p in adam.P.items()}
        adam.step()
        return loss, grads, expected

    def reference(self, corpus, Q=ref_model.exact, half=False):
        """The reference's compared steps from the seed's weights and its
        replay of the checked window step from the program's state copied
        before it: ((losses, first gradient norms, change norms), (loss,
        gradient norms, change norms), the expected batches).  ``half``
        leaves every other row of each batch out of the loss (a planted
        fault)."""
        ctx, dev, hp = self.ctx, self.ctx.device, self.ctx.ref_hp
        budget = 0.3 * torch.cuda.mem_get_info(dev)[0] \
            if dev.type == "cuda" else None
        P = weights_for(ctx)
        for n, t in P.items():
            t.requires_grad_(ref_model.is_parameter(n))
        start = {n: t.detach().clone() for n, t in P.items()
                 if t.requires_grad}
        adam = Adam(P, hp)
        losses, grads, expected = [], None, []
        for k, rec in enumerate(self.compared):
            loss, g, want = self._reference_step(P, adam, corpus,
                                                 rec["names"], k, Q, half,
                                                 budget)
            losses.append(loss)
            grads = g if grads is None else grads
            expected.append(want)
        with torch.no_grad():
            updates = {n: float((P[n] - start[n]).norm()) for n in start}
        del P, start, adam

        c = self.checked
        P = weights_for(ctx)
        with torch.no_grad():
            for n, t in c["before"]["params"].items():
                P[n] = t.detach().clone().float()
        for n, t in P.items():
            t.requires_grad_(ref_model.is_parameter(n))
        adam = Adam(P, hp)
        adam.t = c["before"]["step"]
        for n in adam.P:
            adam.m[n] = c["before"]["exp_avg"][n].clone().float()
            adam.v[n] = c["before"]["exp_avg_sq"][n].clone().float()
        start = {n: t.detach().clone() for n, t in adam.P.items()}
        loss, g, want = self._reference_step(P, adam, corpus, c["names"],
                                             c["before"]["step"], Q, half,
                                             budget)
        with torch.no_grad():
            change = {n: float((P[n] - start[n]).norm()) for n in start}
        expected.append(want)
        return (losses, grads, updates), (loss, g, change), expected

    @staticmethod
    def numbers(prog, ref) -> dict:
        """The compared numbers of the program's ((losses, grads, updates),
        (window loss, grads, change)) against the reference's.  The window
        step's loss gap is not among them: nothing that reads wrong moves
        it (PERF.md); the notes give it."""
        ((pl, pg, pu), (wl, wg, wu)), ((rl, rg, ru), (sl, sg, su)) = \
            prog, ref
        return {
            "loss_gap": max(compare.rel_gap(a, b) for a, b in zip(pl, rl)),
            "grad_gap": compare.norm_gap(pg, rg)[0],
            "update_gap": compare.norm_gap(
                pu, ru, compare.moving_leaves(rg))[0],
            "window_grad_gap": compare.norm_gap(wg, sg)[0],
            "window_update_gap": compare.norm_gap(
                wu, su, compare.moving_leaves(sg))[0]}

    def _program(self):
        """The program's compared readings, read off the card."""
        def floats(d):
            return {n: float(v) for n, v in d.items()}
        c = self.checked
        first = ([float(r["loss"]) for r in self.compared],
                 floats(self.compared[0]["grads"]), floats(self.updates))
        window = (float(c["loss"]), floats(c["grads"]), floats(c["updates"]))
        batches = [{k: v.cpu().numpy() for k, v in r["batch"].items()}
                   for r in self.compared + [c]]
        return (first, window), batches

    def check(self, variants=()):
        """(numbers, notes, extra); with ``variants`` ("fp8", "half") also
        the numbers of each against the reference (the control and a
        fault)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        corpus = Corpus(self.corpus_dir)
        prog, batches = self._program()
        ref_first, ref_window, expected = self.reference(corpus)
        faults = []
        for got, want in zip(batches, expected):
            faults += batch_faults(got, want, self.ctx.ref_hp)
        out = self.numbers(prog, (ref_first, ref_window))
        out["batch_faults"] = len(faults)
        (pl, pg, pu), (wl, wg, wu) = prog
        notes = {"losses": pl, "reference_losses": ref_first[0],
                 "window_loss": wl, "reference_window_loss": ref_window[0],
                 "window_loss_gap": compare.rel_gap(wl, ref_window[0]),
                 "checked_step": self.checked["before"]["step"],
                 "worst_grad_leaf": compare.norm_gap(pg, ref_first[1])[1],
                 "worst_update_leaf": compare.norm_gap(
                     pu, ref_first[2],
                     compare.moving_leaves(ref_first[1]))[1],
                 "worst_window_grad_leaf": compare.norm_gap(
                     wg, ref_window[1])[1],
                 "worst_window_update_leaf": compare.norm_gap(
                     wu, ref_window[2],
                     compare.moving_leaves(ref_window[1]))[1],
                 "batch_fault_list": faults[:5],
                 "batch_rows": [len(r["names"]) for r in
                                self.compared + [self.checked]]}
        extra = {}
        for v in variants:
            first, window, _ = self.reference(
                corpus, Q=ref_model.fp8 if v == "fp8" else ref_model.exact,
                half=v == "half")
            extra[v] = self.numbers((first, window), (ref_first, ref_window))
        self.checked = None
        return out, notes, extra
