"""The attention calls' bound over the device time of the kernels launched
inside the ranges around ops/mha.py's forward and backward, %."""

from gpubench import readers


def read(r):
    return readers.roofline(r, "mha_forward", "mha_backward")
