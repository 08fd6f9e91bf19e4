"""Speech2Text for the LLM-guided model (counterpart of llm_guided_asr_tpu/bin/asr_inference.py).

Built from a model whose weights are already loaded (the config.yaml task
layer is not ported yet).  A call pads the waveform to a multiple of
``speech_pad_multiple`` samples, encodes it, and runs the beam search with
the cached guided scorer.  Results are token ids in the LLM vocabulary;
turning them into text needs the LLM tokenizer, which comes with the task
layer.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch, Hypothesis


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
    ):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.maxlenratio = maxlenratio
        self.minlenratio = minlenratio
        self.nbest = nbest
        self.speech_pad_multiple = speech_pad_multiple
        cfg = model.cfg
        self.beam = BatchBeamSearch(
            model, vocab_size=cfg.vocab_size, sos=cfg.sos_id, eos=cfg.eos_id,
            beam_size=max(beam_size, 1), ctc_weight=ctc_weight, penalty=penalty,
            blank_id=cfg.blank_id,
        )

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
        hyps = self.beam(enc, enc_lens, maxlenratio=self.maxlenratio,
                         minlenratio=self.minlenratio, nbest=self.nbest)
        special = (self.model.cfg.sos_id, self.model.cfg.eos_id)
        return [([i for i in h.yseq if i not in special], h) for h in hyps[: self.nbest]]
