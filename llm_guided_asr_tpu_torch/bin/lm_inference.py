#!/usr/bin/env python3
"""LM generation CLI (counterpart of llm_guided_asr_tpu/bin/lm_inference.py;
espnet2/bin/lm_inference.py analog): continues each text prompt with a
trained LM, greedily (``--temperature 0``) or by sampling from the
softmax of logits / temperature with a ``torch.Generator`` seeded by
``--seed``.  A drawn end of sentence stops the continuation.  Sampled
continuations cannot equal the JAX package's, whose draws come from
``jax.random``.

    python -m llm_guided_asr_tpu_torch.bin.lm_inference --train_config exp/lm/config.yaml \
        --model_file exp/lm/valid.loss.ave_1best.pth --text prompts --output_dir gen \
        [--n_new 30] [--temperature 0.8 --seed 0] [--device cpu]
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Dict, Optional, Union

import torch

logger = logging.getLogger(__name__)


@torch.inference_mode()
def inference(output_dir: Union[str, Path], text: str, train_config: str,
              model_file: Optional[str] = None, n_new: int = 30, temperature: float = 0.0,
              seed: int = 0, device: Union[str, torch.device] = "cuda") -> Dict[str, str]:
    """Write ``<output_dir>/text`` (``uid continuation``) for every
    ``uid prompt`` line of ``text``; returns {uid: continuation}."""
    from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text
    from llm_guided_asr_tpu_torch.tasks.asr import build_text_converter
    from llm_guided_asr_tpu_torch.tasks.lm import LMTask

    model, config = LMTask.build_model_from_file(train_config, model_file, device)
    dev = next(model.parameters()).device
    tokenizer, converter = build_text_converter(config)
    sos = model.vocab_size - 1
    gen = torch.Generator().manual_seed(int(seed))
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    result: Dict[str, str] = {}
    for uid, prompt in read_2columns_text(text).items():
        ids = [sos] + converter.tokens2ids(tokenizer.text2tokens(prompt))
        buf = torch.zeros((1, len(ids) + n_new), dtype=torch.long, device=dev)
        buf[0, : len(ids)] = torch.tensor(ids)
        cur = len(ids)
        for _ in range(n_new):
            logits = model.lm(buf, torch.tensor([cur], device=dev))[0, cur - 1].float()
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1).cpu()
                nxt = int(torch.multinomial(probs, 1, generator=gen))
            else:
                nxt = int(torch.argmax(logits))
            if nxt == sos:  # end of sentence
                break
            buf[0, cur] = nxt
            cur += 1
        cont = buf[0, len(ids):cur].tolist()
        result[uid] = tokenizer.tokens2text(converter.ids2tokens(cont))
    with open(out / "text", "w") as f:
        for uid, line in result.items():
            f.write(f"{uid} {line}\n")
    logger.info(f"generated {len(result)} continuations -> {out}")
    return result


def main(cmd=None) -> Dict[str, str]:
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "output_dir": "lm_generated",
        "text": None,
        "train_config": None,
        "model_file": None,
        "n_new": 30,
        "temperature": 0.0,
        "seed": 0,
        "device": "cuda",
    })
    logging.basicConfig(level=logging.INFO)
    return inference(config["output_dir"], config["text"], config["train_config"],
                     config.get("model_file"), n_new=int(config.get("n_new", 30)),
                     temperature=float(config.get("temperature", 0.0)),
                     seed=int(config.get("seed", 0)), device=config.get("device") or "cuda")


if __name__ == "__main__":
    main()
