"""Device ms a traced request under the range around vocode_batch."""

from gpubench import readers


def read(r):
    return readers.entry_ms_per_unit(r, "vocode_batch")
