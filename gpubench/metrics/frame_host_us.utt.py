"""Host us a frame step of the frame loop at B=1: the program's inclusive
``synth.frame`` over its ``synth.frame_steps`` counter, in the unprofiled
window after the traced requests."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_counter(
        ws, ("synth.frame",), "synth.frame_steps", 1e6)


def read(r):
    return value(program_spans.windows())
