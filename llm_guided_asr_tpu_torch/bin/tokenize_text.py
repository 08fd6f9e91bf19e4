#!/usr/bin/env python3
"""Tokenize a Kaldi-style text file; optionally write a vocabulary (counterpart
of llm_guided_asr_tpu/bin/tokenize_text.py).

Rebuild of espnet2/bin/tokenize_text.py (used by asr.sh:877-968 token-list
generation): reads 'uttid text' (or raw lines with --no_utt_id), writes the
token sequence per line, and with --write_vocabulary emits the sorted token
list with <blank>/<unk>/<sos/eos> placed like the reference
(--add_symbol "<blank>:0" style).
"""

from __future__ import annotations

import logging
import sys
from collections import Counter

logger = logging.getLogger(__name__)


def tokenize(
    input_file: str,
    output_file: str,
    token_type: str = "char",
    bpemodel: str = None,
    write_vocabulary: bool = False,
    vocabulary_size: int = 0,
    cutoff: int = 0,
    add_symbol: list = (),
    field: str = "2-",
    delimiter: str = None,
):
    from llm_guided_asr_tpu_torch.text.tokenizers import build_tokenizer

    tok = build_tokenizer(token_type, bpemodel=bpemodel)
    counter: Counter = Counter()
    out_lines = []
    inp = sys.stdin if input_file == "-" else open(input_file, encoding="utf-8")
    with inp:
        for line in inp:
            line = line.rstrip("\n")
            if not line:
                continue
            if field == "2-":
                parts = line.split(maxsplit=1)
                uid, text = parts[0], (parts[1] if len(parts) > 1 else "")
                prefix = uid + " "
            else:
                text, prefix = line, ""
            tokens = tok.text2tokens(text)
            counter.update(tokens)
            out_lines.append(prefix + " ".join(tokens))
    out = sys.stdout if output_file == "-" else open(output_file, "w", encoding="utf-8")
    with out:
        if write_vocabulary:
            # frequency-sorted vocabulary with pinned symbols (tokenize_text.py
            # --add_symbol '<blank>:0' '<unk>:1' '<sos/eos>:-1')
            words = [w for w, c in counter.most_common() if c > cutoff]
            if vocabulary_size > 0:
                words = words[: vocabulary_size]
            pinned = []
            for spec in add_symbol:
                sym, _, pos = spec.rpartition(":")
                pinned.append((sym, int(pos)))
            for sym, pos in pinned:
                if pos < 0:
                    pos = len(words) + 1 + pos + sum(1 for _, p in pinned if p < 0)
                words.insert(min(pos, len(words)), sym)
            for w in words:
                out.write(w + "\n")
        else:
            for line in out_lines:
                out.write(line + "\n")


def main(cmd=None):
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "input": "-", "output": "-", "token_type": "char", "bpemodel": None,
        "write_vocabulary": False, "vocabulary_size": 0, "cutoff": 0,
        "add_symbol": [], "field": "2-", "delimiter": None,
    })
    logging.basicConfig(level=logging.INFO)
    add_symbol = config.get("add_symbol") or []
    if isinstance(add_symbol, str):
        add_symbol = [add_symbol]
    tokenize(
        config["input"], config["output"], config.get("token_type", "char"),
        config.get("bpemodel"), bool(config.get("write_vocabulary")),
        int(config.get("vocabulary_size", 0)), int(config.get("cutoff", 0)),
        add_symbol, config.get("field", "2-"),
    )


if __name__ == "__main__":
    main()
