"""The fused decode calls' bound over the device time under the range around
decoder_frame_step, %."""

from gpubench import readers


def read(r):
    return readers.roofline(r, "decoder_frame_step")
