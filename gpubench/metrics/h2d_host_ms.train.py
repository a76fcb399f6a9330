"""Host ms of the copy to the card a batch: the program's ``data.h2d``
over its ``data.device_batch`` count, in the unprofiled window after the
traced stretch."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_span(
        ws, ("data.h2d",), "data.device_batch", 1e3)


def read(r):
    return value(program_spans.windows())
