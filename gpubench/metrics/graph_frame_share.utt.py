"""% of the fused frame loop's frames whose chain of small ops between two
decode kernels was replayed from a CUDA graph: the program's
``synth.graph_frames`` counter over it plus ``synth.eager_frames``, in the
unprofiled window after the traced stretch (None without the counters)."""

from gpubench import program_spans


def value(ws):
    return program_spans.counter_share(ws, "synth.graph_frames",
                                       "synth.eager_frames")


def read(r):
    return value(program_spans.windows())
