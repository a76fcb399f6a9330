from .text import (  # noqa: F401
    pad_id, eos_id, sos_id, text_to_byte_sequence, language_name_to_id,
)
