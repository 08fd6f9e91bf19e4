"""Attention-decoder scorer for the beam search (counterpart of llm_guided_asr_tpu/search/scorers.py).

A scorer is three functions over a state dictionary:

  init(enc, enc_len, beam, lmax) -> state
  step(enc, enc_len, state, tokens, lens, step) -> (logp [K, V], state)
  select(state, parent [K]) -> state     (beam reordering)
"""

from __future__ import annotations

from typing import Dict

import torch


class CachedGuidedScorer:
    """LLM-guided decoder scoring with the shared-prefix KV cache: the
    prompt KV is computed once per utterance, then one LLM token per beam
    and step (LLMGuidedASRModel.decode_prefix / decode_step)."""

    # beam axis of each state entry that follows the beam on select();
    # gd_mem_* are utterance-constant and shared by the beam
    _GATHER_AXES = {"k": 0, "v": 0, "kv_valid": 0, "gd_xs": 1}

    def __init__(self, model):
        self.model = model

    def init(self, enc, enc_len, beam: int, lmax: int) -> Dict:
        return self.model.decode_prefix(enc, enc_len.reshape(1), beam, lmax)

    def step(self, enc, enc_len, state, tokens, lens, step: int):
        k = tokens.shape[0]
        last = tokens[torch.arange(k, device=tokens.device), lens - 1]
        return self.model.decode_step(enc, enc_len.reshape(1), state, last, step)

    def select(self, state: Dict, parent: torch.Tensor) -> Dict:
        out = {}
        for key, val in state.items():
            ax = self._GATHER_AXES.get(key)
            if ax is None:
                out[key] = val
            elif isinstance(val, list):
                out[key] = [a.index_select(ax, parent) for a in val]
            else:
                out[key] = val.index_select(ax, parent)
        return out
