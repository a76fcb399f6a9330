"""The traced window: ranges around the program's kernel entries, spans
around the benchmark's own calls, and the reading of the profiler's trace.

With tracing on, ``Tracer.install`` wraps the program's kernel entry
functions (attention forward and backward, the LayerNorm backward, the
fused decode step) in a CPU range named ``gpubench.entry.<name>`` and
records, for every call inside the traced window, the least time its
shapes allow (``counts``).  Device time is given to an entry by the range
its kernels were launched from (CUPTI's correlation of a kernel with its
launch call), not by kernel name, so a later kernel keeps the yardstick.

``TraceSummary`` holds what the metrics read: device busy seconds (the
union of every kernel, copy and set on the device), the traced window's
wall seconds, kernel launches, device seconds and bound seconds per entry,
the device operations that took most time, and the longest idle gaps with
the benchmark span the host was in when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import inspect
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from . import counts

ENTRIES = {
    "mha_forward": ("few_shot_transformer_tts_torch.ops.mha", "mha_forward"),
    "mha_backward": ("few_shot_transformer_tts_torch.ops.mha",
                     "mha_backward"),
    "layer_norm_backward": ("few_shot_transformer_tts_torch.ops.layernorm",
                            "layer_norm_backward"),
    "decoder_frame_step": ("few_shot_transformer_tts_torch.ops.decode",
                           "decoder_frame_step"),
}


def _bound_s(name, a):
    """The least seconds of one entry call, from its bound arguments."""
    if name in ("mha_forward", "mha_backward"):
        q, k = a["q"], a["k"]
        b, tq, c = q.shape
        fn = counts.attention_forward_s if name == "mha_forward" else \
            counts.attention_backward_s
        return fn(b, tq, k.shape[1], c, a["num_heads"], bool(a["causal"]),
                  bool(a["use_bias"]), q.element_size())
    if name == "layer_norm_backward":
        x = a["x"]
        return counts.layernorm_backward_s(x.numel() // x.shape[-1],
                                           x.shape[-1], x.element_size())
    if name == "decoder_frame_step":
        w, ck, mk = a["w"], a["cache_k"], a["mem_k"]
        layers, b, _, c = ck.shape
        elems = sum(w[k].numel() for k in ("w_qkv", "w_out", "w_q", "w_xout",
                                           "w_ffn1", "w_ffn2"))
        return counts.decode_step_s(elems, w["lns"].numel(), layers, b,
                                    mk.shape[2], c, a["num_heads"],
                                    int(a["step"]), ck.element_size())
    raise KeyError(name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    entry_device_s: dict
    entry_bound_s: dict
    entry_calls: dict
    device_ops: list
    idle_gaps: list
    units: int = 0
    extra: dict = field(default_factory=dict)


class Tracer:
    """Spans and the traced window of one run; inert when not enabled."""

    def __init__(self, enabled: bool, workdir: str, device):
        self.enabled = enabled
        self.workdir = workdir
        self.device = torch.device(device)
        self.active = False
        self.bounds = defaultdict(float)
        self.calls = defaultdict(int)
        self._saved = []
        self._prof = None
        self.stop_s = 0.0       # seconds the last stop spent reading

    def warm(self):
        """Start and stop the profiler once (CUPTI's first start takes
        seconds), so that the traced window does not pay for it."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def span(self, name):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function("gpubench.span." + name)

    def entry(self, name):
        """A range of the benchmark's own around a program call."""
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function("gpubench.entry." + name)

    def install(self):
        """Wrap the program's kernel entries (tracing runs only)."""
        if not self.enabled:
            return
        import importlib
        for name, (mod_name, attr) in ENTRIES.items():
            module = importlib.import_module(mod_name)
            orig = getattr(module, attr)
            signature = inspect.signature(orig)

            def wrapper(*args, _name=name, _orig=orig, _sig=signature,
                        **kw):
                if not self.active:
                    return _orig(*args, **kw)
                bound = _sig.bind(*args, **kw)
                bound.apply_defaults()
                self.bounds[_name] += _bound_s(_name, bound.arguments)
                self.calls[_name] += 1
                with torch.profiler.record_function("gpubench.entry." +
                                                    _name):
                    return _orig(*args, **kw)
            functools.update_wrapper(wrapper, orig)
            # the entries count their launches on their module-level name
            wrapper.launches = getattr(orig, "launches", 0)
            setattr(module, attr, wrapper)
            self._saved.append((module, attr, orig))

    def uninstall(self):
        for module, attr, orig in reversed(self._saved):
            orig.launches = getattr(getattr(module, attr), "launches",
                                    getattr(orig, "launches", 0))
            setattr(module, attr, orig)
        self._saved = []

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self, units: int) -> TraceSummary:
        """End the traced window (after its device work) and read it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_end = time.perf_counter()
        window = t_end - self._t0
        self.active = False
        self._prof.stop()
        path = os.path.join(self.workdir, "trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        summary = summarize(events, window, dict(self.bounds),
                            dict(self.calls))
        summary.units = units
        self.stop_s = time.perf_counter() - t_end
        return summary


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Ranges:
    """Ranges of one kind per thread, for 'which range holds time t'."""

    def __init__(self, events):
        by_tid = defaultdict(list)
        for e in events:
            by_tid[e.get("tid")].append((e["ts"], e["ts"] + e.get("dur", 0),
                                         e["name"]))
        self.by_tid = {t: sorted(v) for t, v in by_tid.items()}
        self.starts = {t: [r[0] for r in v] for t, v in self.by_tid.items()}

    def find(self, t, tid=None):
        """The innermost range holding t (on ``tid``, or on any thread)."""
        best = None
        for key in ([tid] if tid is not None else list(self.by_tid)):
            rows = self.by_tid.get(key, ())
            i = bisect.bisect_right(self.starts.get(key, ()), t)
            for s, e, name in reversed(rows[max(0, i - 64):i]):
                if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
        return None if best is None else best[2]


def summarize(events, window_s, bounds, calls) -> TraceSummary:
    device = [e for e in events if e.get("cat") in _DEVICE_CATS and
              "dur" in e]
    kernels = [e for e in device if e["cat"] == "kernel"]
    launches = {}
    for e in events:
        cat = e.get("cat", "")
        corr = e.get("args", {}).get("correlation")
        if corr is not None and cat in ("cuda_runtime", "cuda_driver"):
            launches[corr] = e
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and "dur" in e]
    entries = _Ranges([e for e in ranges
                       if e["name"].startswith("gpubench.entry.")])
    spans = _Ranges([e for e in ranges
                     if e["name"].startswith("gpubench.span.")])
    entry_s = defaultdict(float)
    unmatched = 0
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            unmatched += 1
            continue
        name = entries.find(launch["ts"], launch.get("tid"))
        if name is not None:
            entry_s[name[len("gpubench.entry."):]] += k["dur"] * 1e-6
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name = defaultdict(float)
    for e in device:
        by_name[e["name"][:64]] += e["dur"] * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        name = spans.find(e0)
        gaps.append(((name or "gpubench.span.other")[len("gpubench.span."):],
                     (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(window_s, busy_s, len(kernels), dict(entry_s),
                        bounds, calls, [list(t) for t in top],
                        [list(g) for g in gaps[:10]],
                        extra={"kernels_without_launch": unmatched})
