"""What the per-layer metrics read, and the general readers they share.

Each ``metrics/<name>.py`` is ``read(r)`` of a ``Readings``: a number, or
None where the run gave nothing to read (no traced window, no device time
under the entry), and the harness then leaves the metric out of the line.
A share of a roofline or of a peak is never made up as 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .counts import PEAK_FLOPS
from .trace import TraceSummary


@dataclass
class Readings:
    units: int                      # steps, calls or requests in the window
    counts: dict = field(default_factory=dict)
    untraced_flops: float = 0.0     # model FLOPs of the units after the trace
    untraced_s: float = 0.0         # and the seconds they took
    peak_bytes: int = 0
    trace: Optional[TraceSummary] = None


def idle_share(r: Readings):
    """% of the traced window in which nothing ran on the device."""
    t = r.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def launches_per(r: Readings, count_key: str):
    """Kernel launches of the traced window over a count of it."""
    t = r.trace
    n = None if t is None else t.extra.get(count_key)
    if not n or not t.kernels:
        return None
    return t.kernels / n


def roofline(r: Readings, *entries):
    """% of the least time the entries' calls allow, over the device time
    of the kernels launched inside their ranges."""
    t = r.trace
    if t is None:
        return None
    device = sum(t.entry_device_s.get(e, 0.0) for e in entries)
    bound = sum(t.entry_bound_s.get(e, 0.0) for e in entries)
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device


def mfu(r: Readings):
    """% of the bf16 peak: model FLOPs of the untraced units over their
    seconds."""
    if r.untraced_s <= 0 or r.untraced_flops <= 0:
        return None
    return 100.0 * r.untraced_flops / r.untraced_s / PEAK_FLOPS[2]


def entry_ms_per_unit(r: Readings, entry: str):
    t = r.trace
    if t is None or not t.units or t.entry_device_s.get(entry, 0.0) <= 0:
        return None
    return 1e3 * t.entry_device_s[entry] / t.units


def count_ratio(r: Readings, num: str, den: str, scale: float = 1.0):
    d = r.counts.get(den)
    if not d:
        return None
    return scale * r.counts.get(num, 0.0) / d
