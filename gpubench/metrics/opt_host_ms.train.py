"""Host ms a step of the optimizer (zero_grad, Adam, the schedule): the
program's inclusive ``train.optimizer`` over its ``train.step`` count, in
the unprofiled window after the traced stretch."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_span(
        ws, ("train.optimizer",), "train.step", 1e3)


def read(r):
    return value(program_spans.windows())
