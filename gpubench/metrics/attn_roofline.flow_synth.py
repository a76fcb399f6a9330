"""The attention forward calls' bound (``counts.attention_forward_s`` at
each call's shapes: F5's bidirectional rows, 16 heads of 64) over the
device time of the kernels launched inside the range around
``ops/mha.py``'s forward, %."""

from gpubench import readers


def read(r):
    return readers.roofline(r, "mha_forward")
