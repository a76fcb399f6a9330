"""Host ms a step spent in the Feeder's get_batch (the benchmark's span), over
the window's steps."""

from gpubench import readers


def read(r):
    return readers.count_ratio(r, "feeder_wait_s", "steps", 1e3)
