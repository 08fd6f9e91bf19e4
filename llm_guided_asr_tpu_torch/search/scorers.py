"""Attention-decoder scorers for the beam search (counterpart of llm_guided_asr_tpu/search/scorers.py).

A scorer is three functions over a state dictionary, for B lanes
(utterances decoded in lockstep) of K hypotheses, whose rows are laid out
lane-major (row = lane * K + k):

  init(enc [B, T, D], enc_lens [B], beam K, lmax, ctx=None) -> state
  step(enc, enc_lens, state, tokens [B*K, L], lens [B*K], step) -> (logp [B*K, V], state)
  select(state, rows [B*K]) -> state     (beam reordering: row lane * K + parent)

One lane is the single-utterance search (``enc_lens`` may then be a
scalar).  The JAX package writes the scorers for one lane and vmaps them.

- StatelessAttScorer: the whole prefix recomputed at every step through the
  model's ``decoder_logits`` (the CTC/attention ASRModel); no state.
- CachedGuidedScorer: the LLM-guided decoder with the shared-prefix KV
  cache, and the per-utterance biasing words of a ``((BIAS))`` template.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def lane_rows(x: torch.Tensor, beam: int) -> torch.Tensor:
    """[B, ...] per-lane values -> [B*K, ...] rows, lane-major; a view for
    one lane."""
    b = x.shape[0]
    return x[:, None].expand(b, beam, *x.shape[1:]).reshape(b * beam, *x.shape[1:])


class StatelessAttScorer:
    """Full-prefix decoder scoring: each step runs the decoder over the B*K
    prefixes against their lane's encoder output and keeps the logits at
    each prefix's last position."""

    def __init__(self, model):
        self.model = model

    def init(self, enc, enc_lens, beam: int, lmax: int, ctx=None) -> Dict:
        return {}

    def step(self, enc, enc_lens, state, tokens, lens, step: int):
        beam = tokens.shape[0] // enc.shape[0]
        last = self.model.decoder_logits(lane_rows(enc, beam),
                                         lane_rows(enc_lens.reshape(-1), beam),
                                         tokens, lens, only_last=True)
        return torch.log_softmax(last.float(), dim=-1), state

    def select(self, state: Dict, rows: torch.Tensor) -> Dict:
        return state


class CachedGuidedScorer:
    """LLM-guided decoder scoring with the shared-prefix KV cache: the
    prompt KV is computed once per utterance, then one LLM token per beam
    and step (LLMGuidedASRModel.decode_prefix / decode_step).

    Biasing words reach ``init`` as ``ctx=(ids [1 or B, W], lengths)``, per
    call, so switching them between utterances never reuses the previous
    ones; :meth:`set_bias` sets those used when a call passes none.
    """

    # row axis of each state entry that follows the beam on select();
    # gd_mem_* and prompt_nvalid are per lane and shared by its beam
    _GATHER_AXES = {"k": 0, "v": 0, "kv_valid": 0, "gd_xs": 1}

    def __init__(self, model):
        self.model = model
        self.bias: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def set_bias(self, bias_words, bias_words_lengths) -> None:
        self.bias = None if bias_words is None else (bias_words, bias_words_lengths)

    def init(self, enc, enc_lens, beam: int, lmax: int, ctx=None) -> Dict:
        ctx = ctx if ctx is not None else self.bias
        bias = {} if ctx is None else dict(bias_words=ctx[0], bias_words_lengths=ctx[1])
        return self.model.decode_prefix(enc, enc_lens.reshape(-1), beam, lmax, **bias)

    def step(self, enc, enc_lens, state, tokens, lens, step: int):
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        return self.model.decode_step(enc, enc_lens.reshape(-1), state, tokens[rows, lens - 1],
                                      step)

    def select(self, state: Dict, rows: torch.Tensor) -> Dict:
        out = {}
        for key, val in state.items():
            ax = self._GATHER_AXES.get(key)
            if ax is None:
                out[key] = val
            elif isinstance(val, list):
                out[key] = [a.index_select(ax, rows) for a in val]
            else:
                out[key] = val.index_select(ax, rows)
        return out
