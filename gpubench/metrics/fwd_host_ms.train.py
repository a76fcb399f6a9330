"""Host ms a step of the forward and the loss: the program's inclusive
``train.forward`` + ``train.loss`` over its ``train.step`` count, in the
unprofiled window after the traced stretch."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_span(
        ws, ("train.forward", "train.loss"), "train.step", 1e3)


def read(r):
    return value(program_spans.windows())
