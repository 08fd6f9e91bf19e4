#!/usr/bin/env python3
"""Corpus perplexity CLI (counterpart of llm_guided_asr_tpu/bin/lm_calc_perplexity.py;
espnet2/bin/lm_calc_perplexity.py analog): a shim over tasks/lm.py
``calc_perplexity``.

    python -m llm_guided_asr_tpu_torch.bin.lm_calc_perplexity \
        --train_config exp/lm/config.yaml --model_file exp/lm/valid.loss.ave_1best.pth \
        --data_path_and_name_and_type data/valid/text,text,text [--output_dir d]
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path


def main(cmd=None) -> float:
    from llm_guided_asr_tpu_torch.tasks.lm import calc_perplexity
    from llm_guided_asr_tpu_torch.utils.config import build_config, normalize_triples

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "train_config": None,
        "model_file": None,
        "data_path_and_name_and_type": [],
        "batch_size": 32,
        "output_dir": None,
        "device": "cuda",
    })
    logging.basicConfig(level=logging.INFO)
    ppl = calc_perplexity(config["train_config"], config["model_file"],
                          normalize_triples(config["data_path_and_name_and_type"]),
                          batch_size=int(config.get("batch_size", 32)),
                          device=config.get("device") or "cuda")
    print(f"perplexity: {ppl:.4f}")
    if config.get("output_dir"):
        out = Path(config["output_dir"])
        out.mkdir(parents=True, exist_ok=True)
        (out / "perplexity").write_text(f"{ppl}\n")
    return ppl


if __name__ == "__main__":
    main()
