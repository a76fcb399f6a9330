"""Host ms an Euler step of the flow sampler: the program's inclusive
``synth.ode_step`` (one step's guided pass over both CFG halves) over its
``synth.ode_steps`` counter, in the unprofiled window after the traced
call."""

from gpubench import program_spans


def value(ws):
    return program_spans.spans_per_counter(
        ws, ("synth.ode_step",), "synth.ode_steps", 1e3)


def read(r):
    return value(program_spans.windows())
