from .tacotron import ByteToMel  # noqa: F401
