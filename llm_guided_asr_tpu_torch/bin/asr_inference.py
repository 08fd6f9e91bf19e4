"""Speech2Text (counterpart of llm_guided_asr_tpu/bin/asr_inference.py).

Built from a model whose weights are already loaded (the config.yaml task
layer is not ported yet).  A call pads the waveform to a multiple of
``speech_pad_multiple`` samples, encodes it and searches:

- the LLM-guided model (a model with ``decode_prefix``): the beam search
  with the cached guided scorer; ``biasing_words`` are tokenized with the
  LLM tokenizer and packed at the template's ``((BIAS))`` slot, per call;
- the CTC/attention ASRModel: the beam search with the stateless
  full-prefix scorer, or with the per-beam KV cache of
  search/cached_decoder.py when ``use_cached_decoder``; the greedy CTC
  decode when ``beam_size <= 1`` and ``ctc_weight == 1.0``;
- shallow fusion (asr_inference.py:184-196): ``lm`` is a language model
  of models/lm.py (its ESPnetLanguageModel or the bare LM) or a score
  function (tokens [N, L], lengths [N]) -> log-probs [N, V], such as the
  dense n-gram's; the search adds it with ``lm_weight``.  The JAX
  ``lm_train_config``/``lm_file`` arguments need the task layer, which is
  not ported yet;
- a transducer (a model with ``joint_full``): the fixed-expansion beam
  search when ``beam_size > 1``, the greedy decode when it is 1.

``batch_call`` decodes several requests in one encode and one lockstep
beam search (``BatchBeamSearch.batch_decode``); it decodes them one by one
where the JAX package does: for a transducer and for a model without a
beam search.

Results are (token_ids, Hypothesis) pairs, or (text, tokens, token_ids,
Hypothesis) as in the JAX package when the LLM's tokenizer is given
(text/tokenizers.py ``HuggingFaceTokenizer``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.lm import make_lm_score_fn
from llm_guided_asr_tpu_torch.models.transducer import transducer_greedy_decode
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch, Hypothesis
from llm_guided_asr_tpu_torch.search.cached_decoder import CachedDecoderScorer
from llm_guided_asr_tpu_torch.search.greedy import ctc_greedy_decode
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer
from llm_guided_asr_tpu_torch.search.transducer_beam import transducer_beam_decode
from llm_guided_asr_tpu_torch.text.tokenizers import (
    HuggingFaceTokenIDConverter,
    HuggingFaceTokenizer,
)

TRANSDUCER_SEARCHES = ("default", "alsd", "tsd", "nsc", "mbg")


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class Speech2Text:
    """callable: speech waveform -> list of (token_ids, Hypothesis), or of
    (text, tokens, token_ids, Hypothesis) with a tokenizer."""

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
        use_cached_decoder: bool = False,
        tokenizer: Optional[HuggingFaceTokenizer] = None,
        lm: Optional[Union[nn.Module, Callable]] = None,
        lm_weight: float = 1.0,
        pre_beam_ratio: float = 1.5,
    ):
        """``tokenizer``: the LLM's (text/tokenizers.py); results then carry
        text and tokens, and biasing words can be tokenized.
        ``use_cached_decoder``: the standard decoder scores with its per-beam
        KV cache instead of recomputing the prefix (opt in, as in JAX).
        ``lm``, ``lm_weight``: shallow fusion (the weight is 0 without an
        LM); ``pre_beam_ratio``: the pre-beam keeps int(ratio * beam)
        candidates a hypothesis."""
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.maxlenratio = maxlenratio
        self.minlenratio = minlenratio
        self.nbest = nbest
        self.speech_pad_multiple = speech_pad_multiple
        self.beam_size = beam_size
        self.is_transducer = hasattr(model, "joint_full")
        self.beam = None
        self.tokenizer = tokenizer
        self.converter = (None if tokenizer is None
                          else HuggingFaceTokenIDConverter(tokenizer.tokenizer))
        if isinstance(lm, nn.Module):
            lm = make_lm_score_fn(getattr(lm, "lm", lm))
        self.lm_weight = lm_weight if lm is not None else 0.0
        cfg = model.cfg
        if self.is_transducer:
            if transducer_search not in TRANSDUCER_SEARCHES:
                raise ValueError(f"transducer_search={transducer_search!r}")
            if transducer_search != "default":
                raise NotImplementedError(
                    f"transducer_search={transducer_search!r} is not ported yet")
        elif beam_size > 1 or ctc_weight < 1.0:
            # the guided model scores with its shared-prefix KV cache, any
            # other attention model with the stateless full-prefix scorer or,
            # opted in, the standard decoder's per-beam KV cache
            att_scorer = None
            if hasattr(model, "decode_prefix"):
                att_scorer = CachedGuidedScorer(model)
            elif use_cached_decoder and hasattr(model, "decoder") and cfg.ctc_weight < 1.0:
                att_scorer = CachedDecoderScorer(model, cfg.decoder.attention_heads,
                                                 cfg.decoder.num_blocks)
            self.beam = BatchBeamSearch(
                model, vocab_size=cfg.vocab_size, sos=cfg.sos_id, eos=cfg.eos_id,
                beam_size=max(beam_size, 1), ctc_weight=ctc_weight, penalty=penalty,
                lm_score_fn=lm, lm_weight=self.lm_weight, blank_id=cfg.blank_id,
                pre_beam_ratio=pre_beam_ratio, att_scorer=att_scorer,
            )

    def _transducer_search(self, enc, enc_lens) -> List[Hypothesis]:
        if self.beam_size > 1:
            return transducer_beam_decode(self.model, enc, enc_lens, beam_size=self.beam_size,
                                          nbest=self.nbest)
        tokens, n = transducer_greedy_decode(self.model, enc, enc_lens)
        return [Hypothesis(yseq=tokens[0, : int(n[0])].tolist(), score=0.0, scores={})]

    def make_bias_ctx(self, words: Optional[Sequence[str]], pad_multiple: int = 64):
        """Per-utterance contextual biasing: the words joined by ", ",
        tokenized with the LLM tokenizer (a leading bos dropped), padded to a
        multiple of ``pad_multiple`` ids -> (ids [1, W], lengths [1]) on the
        model's device, or None where there is nothing to bias."""
        scorer = self.beam.att_scorer if self.beam is not None else None
        if not isinstance(scorer, CachedGuidedScorer) or not words:
            return None
        if self.tokenizer is None:
            raise ValueError("biasing words need the LLM tokenizer (tokenizer=HuggingFaceTokenizer)")
        llm_tok = self.tokenizer.tokenizer
        ids = llm_tok(", ".join(words))["input_ids"]
        if llm_tok.bos_token_id is not None and ids and ids[0] == llm_tok.bos_token_id:
            ids = ids[1:]
        w = round_up(max(len(ids), 1), pad_multiple)
        arr = np.zeros((1, w), np.int64)
        arr[0, : len(ids)] = ids[:w]
        return (torch.from_numpy(arr).to(self.device),
                torch.tensor([min(len(ids), w)], device=self.device))

    def _results(self, hyps: List[Hypothesis]) -> list:
        special = (self.model.cfg.sos_id, self.model.cfg.eos_id)
        out = []
        for h in hyps[: self.nbest]:
            ids = [i for i in h.yseq if i not in special]
            if self.tokenizer is None:
                out.append((ids, h))
            else:
                tokens = self.converter.ids2tokens(ids)
                out.append((self.tokenizer.tokens2text(tokens), tokens, ids, h))
        return out

    @torch.inference_mode()
    def __call__(self, speech: np.ndarray, biasing_words: Optional[Sequence[str]] = None) -> list:
        """Decode one utterance (asr_inference.py Speech2Text.__call__:491)."""
        bias_ctx = self.make_bias_ctx(biasing_words)
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
                             minlenratio=self.minlenratio, nbest=self.nbest, scorer_ctx=bias_ctx)
        else:
            tokens, n = ctc_greedy_decode(self.model.ctc_log_softmax(enc), enc_lens,
                                          blank_id=self.model.cfg.blank_id)
            hyps = [Hypothesis(yseq=tokens[0, : int(n[0])].tolist(), score=0.0, scores={})]
        return self._results(hyps)

    @torch.inference_mode()
    def batch_call(self, speeches: Sequence[np.ndarray]) -> List[list]:
        """Decode several requests in one encode and one lockstep beam
        search: the batch is padded to the longest request rounded up to
        ``speech_pad_multiple``.  A transducer or a model without a beam
        search decodes them one by one, as in the JAX package."""
        if self.beam is None or self.is_transducer:
            return [self(s) for s in speeches]
        n = round_up(max(max(len(s) for s in speeches), 1), self.speech_pad_multiple)
        batch = np.zeros((len(speeches), n), np.float32)
        lens = np.zeros((len(speeches),), np.int64)
        for i, s in enumerate(speeches):
            batch[i, : len(s)] = np.asarray(s, np.float32)
            lens[i] = len(s)
        enc, enc_lens = self.model.encode(torch.from_numpy(batch).to(self.device),
                                          torch.from_numpy(lens).to(self.device))
        per_utt = self.beam.batch_decode(enc, enc_lens, maxlenratio=self.maxlenratio,
                                         minlenratio=self.minlenratio, nbest=self.nbest)
        return [self._results(hyps) for hyps in per_utt]
