"""Spans and counters of the port: where the host's time goes inside a step,
a call or a request, and on the profiler's clock while one records.

``span(name)`` is a context manager.  It always adds its host duration
(``time.perf_counter_ns``) to a per-thread table: the count, the inclusive
ns, and the self ns (the duration less what its child spans on the same
thread cover).  While a torch profiler records, it also enters
``torch.profiler.record_function(name)``, so that the span is a
``user_annotation`` range of the same Chrome trace as the kernels.  Outside
a profile no ``record_function`` runs.  ``count(name, n)`` adds to a
counter of the same table.

Names are ``<layer>.<part>`` (``LAYERS``): ``data.*`` the Feeder and the
copy to the card, ``train.*`` the train step, ``ops.*`` the kernel entries,
``synth.*`` the frame loop, ``vocode.*`` Griffin-Lim.

Windows: a new window starts whenever the profiler's state changes (checked
on span entry and on ``count``), so host time taken under a profiler, which
carries the profiler's cost on every op, stays apart from host time taken
without one.  The last ``KEEP_WINDOWS`` windows are kept; ``windows()``
merges each one's per-thread tables.  ``idle_gaps`` and ``busy_share`` read
a Chrome trace: the device's busy union, and each gap in it put down to the
innermost program span the host was in when the gap began.

The state is process-wide, as the profiler's is; ``reset()`` clears it.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

# ``_profiler._is_profiler_enabled``: a process-wide bool that the profiler
# sets on start and clears on stop; cheaper to read than the C++ query
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

LAYERS = ("data", "train", "ops", "synth", "vocode")
KEEP_WINDOWS = 8
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_now = time.perf_counter_ns


class _Window:
    __slots__ = ("index", "profiled", "threads")

    def __init__(self, index: int, profiled: bool):
        self.index = index
        self.profiled = profiled
        self.threads = []       # (spans, counters) of each thread


class _Thread:
    """A thread's tables in its current window."""
    __slots__ = ("window", "spans", "counters", "closed", "last")

    def __init__(self):
        self.window = None
        # ns of the spans closed since the open span began (its children),
        # or since the thread began
        self.closed = 0
        self.last = 0           # ns of the last span closed

    def attach(self, window: _Window):
        self.window = window
        self.spans, self.counters = {}, {}
        with _lock:
            window.threads.append((self.spans, self.counters))


_lock = threading.Lock()
_local = threading.local()
_windows = deque([_Window(0, False)], maxlen=KEEP_WINDOWS)
# the current window of each profiler state ([off, on]); the other state's
# is None, so that a span that sees the state change opens a new window
_by_state = [_windows[-1], None]


def _thread() -> _Thread:
    """This thread's tables, in a new window if the profiler's state
    changed."""
    on = _profiler._is_profiler_enabled
    w = _by_state[on]
    if w is None:
        with _lock:
            w = _by_state[on]
            if w is None:
                w = _Window(_windows[-1].index + 1, on)
                _windows.append(w)
                _by_state[on], _by_state[not on] = w, None
    try:
        t = _local.thread
    except AttributeError:
        t = _local.thread = _Thread()
    if t.window is not w:
        t.attach(w)
    return t


class span:
    """``with span("train.forward"):`` -- see the module's note."""
    __slots__ = ("name", "_t", "_c0", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        on = _profiler._is_profiler_enabled
        try:
            t = _local.thread
            if t.window is not _by_state[on]:
                t = _thread()
        except AttributeError:
            t = _thread()
        self._t = t
        self._c0 = t.closed
        if on:
            rf = self._rf = record_function(self.name)
            rf.__enter__()
        else:
            self._rf = None
        self._t0 = _now()
        return self

    def __exit__(self, et, ev, tb):
        d = _now() - self._t0
        t = self._t
        c0 = self._c0
        try:
            row = t.spans[self.name]
        except KeyError:
            row = t.spans[self.name] = [0, 0, 0]
        row[0] += 1
        row[1] += d
        row[2] += d - t.closed + c0
        # the enclosing span's children now hold this span, not its own
        t.closed = c0 + d
        t.last = d
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        return False


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` of this thread's window."""
    c = _thread().counters
    c[name] = c.get(name, 0) + n


def last_seconds() -> float:
    """Seconds of the last span closed on this thread (right after a call
    that opens a span around all its work, that span's)."""
    return _local.thread.last * 1e-9


def windows() -> list:
    """The kept windows, oldest first, each a dict: ``index``, ``profiled``,
    ``spans`` {name: (count, inclusive s, self s)} and ``counters`` {name:
    n} over every thread."""
    with _lock:
        kept = [(w, list(w.threads)) for w in _windows]
    out = []
    for w, threads in kept:
        spans, counters = {}, {}
        for table, cnt in threads:
            for name, (n, incl, own) in dict(table).items():
                a = spans.get(name, (0, 0, 0))
                spans[name] = (a[0] + n, a[1] + incl, a[2] + own)
            for name, v in dict(cnt).items():
                counters[name] = counters.get(name, 0) + v
        out.append({"index": w.index, "profiled": w.profiled,
                    "spans": {k: (n, incl * 1e-9, own * 1e-9)
                              for k, (n, incl, own) in spans.items()},
                    "counters": counters})
    return out


def reset() -> None:
    """Forget every window (a new window 0 starts)."""
    on = _profiler._is_profiler_enabled
    with _lock:
        _windows.clear()
        _windows.append(_Window(0, on))
        _by_state[on], _by_state[not on] = _windows[-1], None
    _local.__dict__.pop("thread", None)


def is_program_span(name: str) -> bool:
    return name.split(".", 1)[0] in LAYERS and "." in name


def _busy(events):
    """The device's busy union [[start us, end us], ...], sorted."""
    out = []
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in _DEVICE_CATS and "dur" in e):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _program_ranges(events):
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
            for e in events if e.get("cat") == "user_annotation" and
            "dur" in e and is_program_span(e["name"])]


def busy_share(events) -> float:
    """Device busy seconds over the seconds from the first program span's
    start to the last device operation's or program span's end (None when
    the trace has neither)."""
    busy, ranges = _busy(events), _program_ranges(events)
    if not busy or not ranges:
        return None
    t0 = min(r[0] for r in ranges)
    t1 = max(busy[-1][1], max(r[1] for r in ranges))
    on = sum(min(e, t1) - max(s, t0) for s, e in busy if e > t0)
    return on / (t1 - t0) if t1 > t0 else None


def idle_gaps(events, top: int = 10) -> list:
    """The ``top`` longest gaps in the device's busy union of a Chrome
    trace's events, longest first: (innermost program span the host was in
    when the gap began, on any thread, or "other"; gap seconds; gap start
    us)."""
    busy = _busy(events)
    gaps = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in
                   zip(busy, busy[1:])), reverse=True)[:top]
    by_tid = {}
    for s, e, name, tid in sorted(_program_ranges(events)):
        by_tid.setdefault(tid, []).append((s, e, name))
    starts = {tid: [r[0] for r in rows] for tid, rows in by_tid.items()}
    out = []
    for gap, t in gaps:
        best = None
        for tid, rows in by_tid.items():
            # nested ranges: the latest start at or before t that still
            # holds t is the innermost on its thread
            for s, e, name in reversed(rows[:bisect.bisect_right(
                    starts[tid], t)]):
                if e >= t:
                    if best is None or e - s < best[1] - best[0]:
                        best = (s, e, name)
                    break
        out.append((best[2] if best else "other", gap * 1e-6, t))
    return out
