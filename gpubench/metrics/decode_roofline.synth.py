"""The fused decode calls' byte/FLOP bound over the device time under the range
around ops/decode.py's decoder_frame_step, %."""

from gpubench import readers


def read(r):
    return readers.roofline(r, "decoder_frame_step")
