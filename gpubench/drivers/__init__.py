"""One driver per traffic kind (``traffic/<mix>.json``'s ``kind``): its
set-up, its timed window and its correctness check."""

import importlib


def driver(kind: str):
    """The driver class of a traffic kind."""
    return importlib.import_module("gpubench.drivers." + kind).Driver
