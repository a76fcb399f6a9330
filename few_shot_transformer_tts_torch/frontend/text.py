"""Byte-level text frontend (own copy of the JAX package's frontend/text.py).

Matches the reference tokenizer (reference: utils/text.py:3-44): text is encoded
as raw UTF-8 bytes with ``pad=0``, ``eos=1``, ``sos=2``.  Note the byte values
0..255 are used as-is, so ids 0..2 are shared with the specials exactly like the
reference (NUL/SOH/STX never occur in normal text); the model vocab (6000) vastly
exceeds the byte range, reserving room for phone ids in the 'nltpi' format.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Union

pad_id = 0
eos_id = 1
sos_id = 2


def text_to_byte_sequence(text: str, use_sos: bool = True, use_eos: bool = True) -> List[int]:
    """Encode text to UTF-8 byte ids, optionally wrapped in sos/eos."""
    s = list(text.encode("utf-8"))
    if use_sos:
        s = [sos_id] + s
    if use_eos:
        s = s + [eos_id]
    return s


def language_name_to_id(lang_to_id: dict, lang: Union[str, Sequence]) -> List[int]:
    """Resolve colon-separated language names (or numeric ids) to id list."""
    id_to_lang = {v: k for k, v in lang_to_id.items()}
    langs = lang.split(":") if isinstance(lang, str) else list(lang)
    out = []
    for item in langs:
        if isinstance(item, str) and item.isnumeric():
            item = int(item)
        if isinstance(item, str):
            if item in lang_to_id:
                out.append(lang_to_id[item])
            else:
                logging.warning("Unknown language requested: %s", item)
        else:
            if item in id_to_lang:
                out.append(item)
            else:
                logging.warning("Unknown language requested: %s", item)
    logging.info("Selected languages: %s", " ".join(id_to_lang[t] for t in out))
    return out



def language_vec_to_id(lv) -> int:
    """First positive index of a one-hot language vector, else -1."""
    for i, v in enumerate(lv):
        if v > 0:
            return i
    return -1
