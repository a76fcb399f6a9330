"""% of the traced window with nothing running on the device."""

from gpubench import readers


def read(r):
    return readers.idle_share(r)
