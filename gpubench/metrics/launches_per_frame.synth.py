"""Kernel launches of the traced calls over their frame steps (one step decodes
a frame of every row)."""

from gpubench import readers


def read(r):
    return readers.launches_per(r, "frame_steps")
