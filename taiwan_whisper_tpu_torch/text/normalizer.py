"""Basic text normalizer applied before the cross-model MER check (port of
taiwan_whisper_tpu/text/normalizer.py): lowercase, drop bracketed asides,
turn symbol, punctuation and mark characters into spaces, collapse
whitespace. Like HF's BasicTextNormalizer it keeps leading and trailing
space.
"""

from __future__ import annotations

import re
import unicodedata

_BRACKETED = re.compile(r"[<\[][^>\]]*[>\]]")
_PARENS = re.compile(r"\(([^)]+?)\)")
_WS = re.compile(r"\s+")


def _remove_symbols(s: str) -> str:
    return "".join(" " if unicodedata.category(c)[0] in "MSP" else c
                   for c in unicodedata.normalize("NFKC", s))


def basic_normalize(text: str, remove_diacritics: bool = False) -> str:
    s = text.lower()
    s = _BRACKETED.sub("", s)
    s = _PARENS.sub("", s)
    if remove_diacritics:
        s = "".join(c for c in unicodedata.normalize("NFKD", s)
                    if unicodedata.category(c) != "Mn")
    return _WS.sub(" ", _remove_symbols(s))


class BasicTextNormalizer:
    """Callable with the interface of HF's class."""

    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.remove_diacritics = remove_diacritics
        self.split_letters = split_letters

    def __call__(self, text: str) -> str:
        s = basic_normalize(text, self.remove_diacritics)
        if self.split_letters:
            s = " ".join(c for c in s if not c.isspace())
        return s
