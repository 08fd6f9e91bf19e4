#!/usr/bin/env python3
"""Export a Hugging Face tokenizer's vocabulary as a token list
(counterpart of llm_guided_asr_tpu/bin/hugging_face_export_vocabulary.py;
espnet2/bin/hugging_face_export_vocabulary.py, the ``hugging_face``
token_type of asr.sh): one token a line in id order, the added tokens
included, so a line's index is the LLM's vocabulary id; an id no token
holds is written ``<unused_{id}>``.  The tokenizer is the port's reader of
a local directory's ``tokenizer.json`` (text/tokenizers.py).

    python -m llm_guided_asr_tpu_torch.bin.hugging_face_export_vocabulary \
        --model_name_or_path path/to/llm --output tokens.txt
"""

from __future__ import annotations

import logging
import sys

logger = logging.getLogger(__name__)


def export_vocabulary(model_name_or_path: str, output: str = "-") -> int:
    """Write the token list to ``output`` ("-": standard output); returns
    its length."""
    from llm_guided_asr_tpu_torch.text.tokenizers import LLMTokenizer

    inv = {i: t for t, i in LLMTokenizer.from_pretrained(model_name_or_path).get_vocab().items()}
    size = max(inv) + 1
    out = sys.stdout if output == "-" else open(output, "w", encoding="utf-8")
    try:
        for i in range(size):
            out.write(inv.get(i, f"<unused_{i}>") + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    logger.info(f"exported {size} tokens from {model_name_or_path}")
    return size


def main(cmd=None) -> int:
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "model_name_or_path": None, "output": "-",
    })
    logging.basicConfig(level=logging.INFO)
    return export_vocabulary(config["model_name_or_path"], config.get("output", "-"))


if __name__ == "__main__":
    main()
