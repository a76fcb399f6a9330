"""DiT FLOPs of the untraced calls (both CFG halves of every Euler step
and the text embedding, at each row's true length; ``f5counts``) over
their seconds, as % of the bf16 peak."""

from gpubench import readers


def read(r):
    return readers.mfu(r)
