"""Model FLOPs of the untraced calls (encoder, memory K/V, every frame,
postnet; true lengths) over their seconds, as % of the bf16 peak."""

from gpubench import readers


def read(r):
    return readers.mfu(r)
