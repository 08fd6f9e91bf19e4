"""Text cleaner bank (the port's own copy of llm_guided_asr_tpu/text/cleaner.py;
espnet2/text/cleaner.py TextCleaner analog).

The reference dispatches to external packages (tacotron_cleaner, jaconv,
whisper.normalizers); none ship here, so the two most-used cleaners
are reimplemented self-contained:

- ``tacotron``: tacotron_cleaner.cleaners.custom_english_cleaners behavior —
  uppercase, abbreviation expansion (mr./dr./jr./...), punctuation and
  bracket stripping, whitespace collapse.
- ``basic``: whisper BasicTextNormalizer behavior — lowercase, drop
  bracketed asides, strip punctuation/diacritics to whitespace-separated
  words.

Unavailable language-specific cleaners (jaconv, vietnamese, korean) raise a
clear error naming the missing dependency.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Collection, List, Optional, Union

_ABBREVIATIONS = [
    ("mrs", "misess"),
    ("mr", "mister"),
    ("dr", "doctor"),
    ("st", "saint"),
    ("co", "company"),
    ("jr", "junior"),
    ("maj", "major"),
    ("gen", "general"),
    ("drs", "doctors"),
    ("rev", "reverend"),
    ("lt", "lieutenant"),
    ("hon", "honorable"),
    ("sgt", "sergeant"),
    ("capt", "captain"),
    ("esq", "esquire"),
    ("ltd", "limited"),
    ("col", "colonel"),
    ("ft", "fort"),
]


def _expand_abbreviations(text: str) -> str:
    for abbr, full in _ABBREVIATIONS:
        text = re.sub(rf"\b{abbr}\.", full, text, flags=re.IGNORECASE)
    return text


def tacotron_clean(text: str) -> str:
    """custom_english_cleaners: expand abbreviations, uppercase, strip
    punctuation (keeping ' between letters), collapse whitespace."""
    text = unicodedata.normalize("NFKD", text)
    text = _expand_abbreviations(text.lower())
    text = re.sub(r"[\(\)\[\]\{\}]", " ", text)
    text = re.sub(r"&", " and ", text)
    text = re.sub(r"[-–—]", " ", text)
    # keep apostrophes inside words; drop other punctuation to ','-free text
    text = re.sub(r"[^a-z0-9' ]", "", text)
    text = re.sub(r"\s+", " ", text).strip()
    return text.upper()


def basic_clean(text: str) -> str:
    """whisper BasicTextNormalizer: lowercase, remove bracketed asides and
    punctuation/diacritics, collapse whitespace."""
    text = text.lower()
    text = re.sub(r"[<\[][^>\]]*[>\]]", "", text)  # <...> / [...] asides
    text = re.sub(r"\([^)]*\)", "", text)
    text = unicodedata.normalize("NFKD", text)
    text = "".join(c for c in text if not unicodedata.combining(c))
    text = "".join(
        c if (c.isalnum() or c.isspace()) else " " for c in text
    )
    return re.sub(r"\s+", " ", text).strip()


class TextCleaner:
    """Apply a chain of cleaners by name (cleaner.py TextCleaner)."""

    KNOWN = ("tacotron", "basic", "whisper_basic", "lower", "upper")

    def __init__(self, cleaner_types: Optional[Union[str, Collection[str]]] = None):
        if cleaner_types is None:
            names: List[str] = []
        elif isinstance(cleaner_types, str):
            names = [cleaner_types]
        else:
            names = list(cleaner_types)
        for n in names:
            if n in ("jaconv", "vietnamese", "korean_cleaner", "whisper_en"):
                raise RuntimeError(
                    f"cleaner {n!r} needs an external package not present in "
                    "this environment (jaconv/underthesea/whisper)"
                )
            if n not in self.KNOWN:
                raise ValueError(f"unknown cleaner {n!r}; known: {self.KNOWN}")
        self.names = names

    def __call__(self, text: str) -> str:
        for n in self.names:
            if n == "tacotron":
                text = tacotron_clean(text)
            elif n in ("basic", "whisper_basic"):
                text = basic_clean(text)
            elif n == "lower":
                text = text.lower()
            elif n == "upper":
                text = text.upper()
        return text
