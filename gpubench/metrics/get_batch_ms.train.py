"""Host ms a batch in the Feeder's ``get_batch``: the program's
``data.get_batch`` over its count, in the unprofiled window after the
traced stretch (the in-program twin of ``feeder_wait_ms.train``)."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_span(
        ws, ("data.get_batch",), "data.get_batch", 1e3)


def read(r):
    return value(program_spans.windows())
