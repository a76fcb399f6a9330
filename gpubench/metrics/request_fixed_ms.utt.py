"""Host ms a request of the work that does not grow with its frames: the
self time of the program's ``synth.prepare``, ``synth.weights``,
``synth.encode``, ``synth.postnet`` and ``vocode.griffin_lim`` over its
``synth.call`` count, in the unprofiled window after the traced
requests."""

from gpubench import program_spans

FIXED = ("synth.prepare", "synth.weights", "synth.encode",
         "synth.postnet", "vocode.griffin_lim")


def value(ws):
    return program_spans.spans_per_span(ws, FIXED, "synth.call", 1e3,
                                        own=True)


def read(r):
    return value(program_spans.windows())
