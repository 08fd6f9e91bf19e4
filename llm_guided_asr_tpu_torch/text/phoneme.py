"""Phoneme tokenizer (the port's own copy of llm_guided_asr_tpu/text/phoneme.py;
espnet2/text/phoneme_tokenizer.py analog).

The reference's g2p bank wraps external engines (pyopenjtalk, g2p_en,
pypinyin, espeak-ng); none ship here.  Two self-contained g2p modes cover
the same API surface:

- ``lexicon:<path>``: CMUdict-format lexicon lookup (``WORD  P1 P2 ...``),
  the g2p used by Kaldi-style recipes; OOV words fall back to letter
  spelling.
- ``rule_en``: deterministic English letter-to-sound rules (coarse ARPAbet
  mapping) — a dependency-free stand-in so phn token_type works end to end.

External engine names raise a clear error naming the missing package.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from llm_guided_asr_tpu_torch.text.tokenizers import AbsTokenizer

_EXTERNAL = (
    "g2p_en", "pyopenjtalk", "pypinyin_g2p", "espeak_ng_english_us_vits",
    "korean_jaso",
)

# very coarse English letter/digraph -> ARPAbet rules (longest-match-first)
_RULES = [
    ("tion", ["SH", "AH", "N"]),
    ("ough", ["AO"]),
    ("igh", ["AY"]),
    ("ch", ["CH"]),
    ("sh", ["SH"]),
    ("th", ["TH"]),
    ("ph", ["F"]),
    ("wh", ["W"]),
    ("ck", ["K"]),
    ("ng", ["NG"]),
    ("qu", ["K", "W"]),
    ("ee", ["IY"]),
    ("oo", ["UW"]),
    ("ou", ["AW"]),
    ("ai", ["EY"]),
    ("ay", ["EY"]),
    ("oi", ["OY"]),
    ("a", ["AE"]),
    ("b", ["B"]),
    ("c", ["K"]),
    ("d", ["D"]),
    ("e", ["EH"]),
    ("f", ["F"]),
    ("g", ["G"]),
    ("h", ["HH"]),
    ("i", ["IH"]),
    ("j", ["JH"]),
    ("k", ["K"]),
    ("l", ["L"]),
    ("m", ["M"]),
    ("n", ["N"]),
    ("o", ["AA"]),
    ("p", ["P"]),
    ("r", ["R"]),
    ("s", ["S"]),
    ("t", ["T"]),
    ("u", ["AH"]),
    ("v", ["V"]),
    ("w", ["W"]),
    ("x", ["K", "S"]),
    ("y", ["Y"]),
    ("z", ["Z"]),
]


def rule_g2p(word: str) -> List[str]:
    word = word.lower()
    out: List[str] = []
    i = 0
    while i < len(word):
        for pat, phones in _RULES:
            if word.startswith(pat, i):
                out.extend(phones)
                i += len(pat)
                break
        else:
            i += 1  # skip unmapped characters
    return out


class PhonemeTokenizer(AbsTokenizer):
    """text -> phoneme tokens; tokens2text joins with spaces (the phoneme
    stream is not invertible to graphemes, matching the reference)."""

    def __init__(self, g2p_type: str = "rule_en",
                 non_linguistic_symbols: Optional[Iterable[str]] = None):
        if g2p_type in _EXTERNAL:
            raise RuntimeError(
                f"g2p {g2p_type!r} needs an external engine not present in "
                "this environment; use 'lexicon:<path>' or 'rule_en'"
            )
        self.g2p_type = g2p_type
        self.lexicon: Dict[str, List[str]] = {}
        if g2p_type.startswith("lexicon:"):
            path = Path(g2p_type.split(":", 1)[1])
            for line in path.read_text().splitlines():
                parts = line.split()
                if len(parts) >= 2:
                    # CMUdict variant markers WORD(2) collapse onto WORD
                    w = re.sub(r"\(\d+\)$", "", parts[0]).lower()
                    self.lexicon.setdefault(w, parts[1:])
        elif g2p_type != "rule_en":
            raise ValueError(f"unknown g2p_type {g2p_type!r}")
        self.non_ling = set(non_linguistic_symbols or ())

    def _word2phones(self, word: str) -> List[str]:
        if word in self.non_ling:
            return [word]
        if self.lexicon:
            phones = self.lexicon.get(word.lower())
            if phones is not None:
                return list(phones)
            # OOV: letter spelling through the lexicon, then rules
            out: List[str] = []
            for ch in word.lower():
                out.extend(self.lexicon.get(ch, rule_g2p(ch)))
            return out
        return rule_g2p(word)

    def text2tokens(self, text: str) -> List[str]:
        tokens: List[str] = []
        for word in text.split():
            tokens.extend(self._word2phones(word))
        return tokens

    def tokens2text(self, tokens: Iterable[str]) -> str:
        return " ".join(tokens)
