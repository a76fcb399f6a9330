"""Padded target frames over all target frames of the window's batches, %: a
count."""

from gpubench import readers


def read(r):
    return readers.count_ratio(r, "padded_frames", "batch_frames", 100.0)
