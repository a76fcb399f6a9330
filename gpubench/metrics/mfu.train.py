"""Model FLOPs of the untraced steps at their rows' true lengths, over their
seconds, as % of the bf16 peak."""

from gpubench import readers


def read(r):
    return readers.mfu(r)
