"""Host ms a step of the backward: the program's inclusive
``train.backward`` over its ``train.step`` count, in the unprofiled window
after the traced stretch."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_span(
        ws, ("train.backward",), "train.step", 1e3)


def read(r):
    return value(program_spans.windows())
