"""The LayerNorm backward calls' bound over the device time of the kernels
launched inside the range around ops/layernorm.py's backward, %."""

from gpubench import readers


def read(r):
    return readers.roofline(r, "layer_norm_backward")
