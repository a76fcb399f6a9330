"""Host ms a call in the frame loop's blocking stop checks: the program's
``synth.stop_check`` over its ``synth.call`` count, in the unprofiled window
after the traced call."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_span(
        ws, ("synth.stop_check",), "synth.call", 1e3)


def read(r):
    return value(program_spans.windows())
