"""What the per-layer readers of the program's own spans and counters
share (``few_shot_transformer_tts_torch/utils/tracing.py``).

The program keeps its host time per span and its counters in windows: a new
window starts whenever a profiler starts or stops.  A reader reads the
unprofiled window that follows the last profiled one: with ``--trace 1``
that is the rest of the timed window after the traced stretch, with no
profiler's cost in it.  Where the program has no such window, or no
tracing module at all, the reader gives None and the harness leaves the
metric out of the line.

A window is a dict: ``profiled``, ``spans`` {name: (count, inclusive s,
self s)} and ``counters`` {name: n}.
"""

from __future__ import annotations


def windows() -> list:
    """The program's kept windows, oldest first ([] without the module)."""
    try:
        from few_shot_transformer_tts_torch.utils import tracing
    except ImportError:
        return []
    return tracing.windows()


def after_trace(ws):
    """The unprofiled window right after the last profiled one, or None."""
    last = max((i for i, w in enumerate(ws) if w["profiled"]), default=None)
    if last is None or last + 1 >= len(ws) or ws[last + 1]["profiled"]:
        return None
    return ws[last + 1]


def _seconds(w, names, own):
    return sum(w["spans"].get(n, (0, 0.0, 0.0))[2 if own else 1]
               for n in names)


def spans_per_span(ws, names, unit, scale, own=False):
    """``scale`` x the seconds of the spans ``names`` (inclusive, or their
    self time with ``own``) over the count of the span ``unit``."""
    w = after_trace(ws)
    n = w and w["spans"].get(unit, (0,))[0]
    return scale * _seconds(w, names, own) / n if n else None


def spans_per_counter(ws, names, counter, scale):
    """``scale`` x the inclusive seconds of ``names`` over a counter."""
    w = after_trace(ws)
    n = w and w["counters"].get(counter, 0)
    return scale * _seconds(w, names, False) / n if n else None


def counter_share(ws, part, rest, scale=100.0):
    """``scale`` x counter ``part`` over ``part`` + ``rest``."""
    w = after_trace(ws)
    if w is None:
        return None
    a, b = w["counters"].get(part, 0), w["counters"].get(rest, 0)
    return scale * a / (a + b) if a + b else None
