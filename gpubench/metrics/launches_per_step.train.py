"""Kernel launches of the traced steps over their number."""

from gpubench import readers


def read(r):
    return readers.launches_per(r, "steps")
