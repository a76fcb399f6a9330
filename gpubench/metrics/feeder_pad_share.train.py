"""Padded target frames over all target frames of the batches the Feeder
handed out, %: its ``data.padded_frames`` and ``data.frames`` counters, in
the unprofiled window after the traced stretch (the in-program twin of
``pad_share.train``)."""

from gpubench import program_spans


def value(ws):
    return program_spans.counter_share(
        ws, "data.padded_frames", "data.frames")


def read(r):
    return value(program_spans.windows())
