"""Speech2Text (counterpart of llm_guided_asr_tpu/bin/asr_inference.py).

Built from a model whose weights are already loaded (the config.yaml task
layer is not ported yet).  A call pads the waveform to a multiple of
``speech_pad_multiple`` samples, encodes it and searches:

- the LLM-guided model (a model with ``decode_prefix``): the beam search
  with the cached guided scorer;
- the CTC/attention ASRModel: the beam search with the stateless
  full-prefix scorer, or the greedy CTC decode when ``beam_size <= 1`` and
  ``ctc_weight == 1.0``;
- a transducer (a model with ``joint_full``): the fixed-expansion beam
  search when ``beam_size > 1``, the greedy decode when it is 1.

Not ported: the opt-in per-beam KV cache of the standard decoder
(``use_cached_decoder``, search/cached_decoder.py).

Results are token ids; turning them into text needs the tokenizer, which
comes with the task layer.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from llm_guided_asr_tpu_torch.models.transducer import transducer_greedy_decode
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch, Hypothesis
from llm_guided_asr_tpu_torch.search.greedy import ctc_greedy_decode
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer
from llm_guided_asr_tpu_torch.search.transducer_beam import transducer_beam_decode

TRANSDUCER_SEARCHES = ("default", "alsd", "tsd", "nsc", "mbg")


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class Speech2Text:
    """callable: speech waveform -> list of (token_ids, Hypothesis)."""

    def __init__(
        self,
        model,
        ctc_weight: float = 0.3,
        beam_size: int = 10,
        penalty: float = 0.0,
        maxlenratio: float = 0.0,
        minlenratio: float = 0.0,
        nbest: int = 1,
        speech_pad_multiple: int = 1600,
        transducer_search: str = "default",
    ):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.maxlenratio = maxlenratio
        self.minlenratio = minlenratio
        self.nbest = nbest
        self.speech_pad_multiple = speech_pad_multiple
        self.beam_size = beam_size
        self.is_transducer = hasattr(model, "joint_full")
        self.beam = None
        cfg = model.cfg
        if self.is_transducer:
            if transducer_search not in TRANSDUCER_SEARCHES:
                raise ValueError(f"transducer_search={transducer_search!r}")
            if transducer_search != "default":
                raise NotImplementedError(
                    f"transducer_search={transducer_search!r} is not ported yet")
        elif beam_size > 1 or ctc_weight < 1.0:
            # the guided model scores with its shared-prefix KV cache, any
            # other attention model with the stateless full-prefix scorer
            att_scorer = CachedGuidedScorer(model) if hasattr(model, "decode_prefix") else None
            self.beam = BatchBeamSearch(
                model, vocab_size=cfg.vocab_size, sos=cfg.sos_id, eos=cfg.eos_id,
                beam_size=max(beam_size, 1), ctc_weight=ctc_weight, penalty=penalty,
                blank_id=cfg.blank_id, att_scorer=att_scorer,
            )

    def _transducer_search(self, enc, enc_lens) -> List[Hypothesis]:
        if self.beam_size > 1:
            return transducer_beam_decode(self.model, enc, enc_lens, beam_size=self.beam_size,
                                          nbest=self.nbest)
        tokens, n = transducer_greedy_decode(self.model, enc, enc_lens)
        return [Hypothesis(yseq=tokens[0, : int(n[0])].tolist(), score=0.0, scores={})]

    @torch.inference_mode()
    def __call__(self, speech: np.ndarray) -> List[Tuple[List[int], Hypothesis]]:
        """Decode one utterance (asr_inference.py Speech2Text.__call__:491)."""
        speech = np.asarray(speech, np.float32)
        n = speech.shape[0]
        padded = np.zeros((round_up(max(n, 1), self.speech_pad_multiple),), np.float32)
        padded[:n] = speech
        enc, enc_lens = self.model.encode(
            torch.from_numpy(padded[None]).to(self.device),
            torch.tensor([n], device=self.device),
        )
        if self.is_transducer:
            hyps = self._transducer_search(enc, enc_lens)
        elif self.beam is not None:
            hyps = self.beam(enc, enc_lens, maxlenratio=self.maxlenratio,
                             minlenratio=self.minlenratio, nbest=self.nbest)
        else:
            tokens, n = ctc_greedy_decode(self.model.ctc_log_softmax(enc), enc_lens,
                                          blank_id=self.model.cfg.blank_id)
            hyps = [Hypothesis(yseq=tokens[0, : int(n[0])].tolist(), score=0.0, scores={})]
        special = (self.model.cfg.sos_id, self.model.cfg.eos_id)
        return [([i for i in h.yseq if i not in special], h) for h in hyps[: self.nbest]]
