"""Native (C++) host components of the port, built at first use with g++:
the zip reader of the mel store (``zipreader``)."""
