"""LM task (counterpart of llm_guided_asr_tpu/tasks/lm.py): building the LM from a config.

:func:`build_lm` builds the ESPnet LM from a config dict as the JAX
``build_lm`` does: ``token_list`` (a file or a list) sets the vocabulary,
``lm`` picks ``transformer`` or ``seq_rnn`` and ``lm_conf`` holds its
fields.  The YAML and checkpoint loading of ``LMTask`` and
``calc_perplexity`` need the task layer and the dataset, which are not
ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from llm_guided_asr_tpu_torch.models.lm import (
    ESPnetLanguageModel,
    SequentialRNNLM,
    SequentialRNNLMConfig,
    TransformerLM,
    TransformerLMConfig,
)
from llm_guided_asr_tpu_torch.utils.config import read_token_list


def build_lm(config: Dict[str, Any],
             device: Union[str, torch.device] = "cuda") -> ESPnetLanguageModel:
    vocab_size = len(read_token_list(config["token_list"]))
    lm_type = config.get("lm", "transformer")
    conf = dict(config.get("lm_conf", {}) or {})
    if lm_type == "transformer":
        lm = TransformerLM(TransformerLMConfig.from_dict(conf, vocab_size), device=device)
    elif lm_type in ("seq_rnn", "sequential_rnn"):
        lm = SequentialRNNLM(SequentialRNNLMConfig.from_dict(conf, vocab_size), device=device)
    else:
        raise ValueError(f"unknown lm type {lm_type!r}")
    return ESPnetLanguageModel(lm, vocab_size)
