"""Joint CTC/attention beam search on the device (counterpart of llm_guided_asr_tpu/search/beam_search.py).

Static-shape tensor steps, one Python iteration per output token:

- the attention scorer scores [K, V]; a pre-beam keeps W = int(1.5*K)
  candidates per hypothesis, with eos appended as a (W+1)-th candidate so
  that it is always CTC-scored (as espnet does);
- the CTC prefix scorer rescores the candidates; scores use the absolute
  prefix probability psi: total = base + att_weight*att + ctc_weight*psi +
  penalty, where base is the cumulative non-CTC part;
- top-K over all candidates first, then the selected eos hypotheses retire
  into a fixed-size finished buffer (espnet beam_search.py:316 and
  post_process:500);
- the loop ends at maxlen or when no alive hypothesis can beat the worst
  finished one; that test reads one scalar from the device per step.

Weights follow asr_inference.py: decoder 1-ctc_weight, ctc ctc_weight,
length bonus penalty.  batch_decode and streaming are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from llm_guided_asr_tpu_torch.search.ctc_prefix import (
    CTCPrefixState,
    ctc_prefix_advance,
    ctc_prefix_init,
    ctc_prefix_psi,
)
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer

NEG_INF = -1.0e10
PRE_BEAM_RATIO = 1.5  # espnet beam_search.py:105


class Hypothesis(NamedTuple):
    """Host-side result (espnet beam_search.py:15)."""

    yseq: List[int]
    score: float
    scores: Dict[str, float]


class BeamState(NamedTuple):
    step: int
    alive_tokens: torch.Tensor  # [K, Lmax] (sos at 0)
    alive_len: torch.Tensor  # [K]
    alive_score: torch.Tensor  # [K] total (= alive_base + ctc_weight * psi)
    alive_base: torch.Tensor  # [K] cumulative non-CTC part
    alive_parts: torch.Tensor  # [K, 4] unweighted (decoder, ctc, lm, length_bonus)
    ctc: CTCPrefixState
    fin_tokens: torch.Tensor  # [K, Lmax]
    fin_len: torch.Tensor  # [K]
    fin_score: torch.Tensor  # [K]
    fin_parts: torch.Tensor  # [K, 4]


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken towards the lower index (as
    lax.top_k does) by a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BatchBeamSearch:
    """Joint CTC/attention beam search over one utterance, with the
    LLM-guided cached decoder as the attention scorer."""

    def __init__(
        self,
        model,
        vocab_size: int,
        sos: int,
        eos: int,
        beam_size: int = 10,
        ctc_weight: float = 0.5,
        penalty: float = 0.0,
        blank_id: int = 0,
    ):
        self.model = model
        self.att_scorer = CachedGuidedScorer(model)
        self.vocab_size = vocab_size
        self.sos = sos
        self.eos = eos
        # espnet clamps the beam to the vocabulary, and the pre-beam width
        # is int(ratio * K) capped at it (beam_search.py:105)
        self.K = min(beam_size, vocab_size)
        self.W = max(1, min(vocab_size, int(PRE_BEAM_RATIO * self.K)))
        self.ctc_weight = float(ctc_weight)
        self.att_weight = 1.0 - float(ctc_weight)
        self.penalty = float(penalty)
        self.blank_id = blank_id

    # -- core loop ------------------------------------------------------
    def _init_carry(self, ctc_logp, enc, enc_len, lmax: int):
        K, dev = self.K, enc.device
        first = torch.where(torch.arange(K, device=dev) == 0, 0.0, NEG_INF)
        init = BeamState(
            step=0,
            alive_tokens=torch.full((K, lmax), self.sos, dtype=torch.int64, device=dev),
            alive_len=torch.ones(K, dtype=torch.int64, device=dev),
            alive_score=first,
            alive_base=first.clone(),
            alive_parts=torch.zeros((K, 4), device=dev),
            ctc=ctc_prefix_init(ctc_logp, enc_len, K, self.blank_id),
            fin_tokens=torch.zeros((K, lmax), dtype=torch.int64, device=dev),
            fin_len=torch.zeros(K, dtype=torch.int64, device=dev),
            fin_score=torch.full((K,), NEG_INF, device=dev),
            fin_parts=torch.zeros((K, 4), device=dev),
        )
        return init, self.att_scorer.init(enc, enc_len, K, lmax)

    def _ctc_table(self, enc):
        if self.ctc_weight != 0.0:
            return self.model.ctc_log_softmax(enc)[0]  # [T, V]
        return torch.zeros((enc.shape[1], self.vocab_size), device=enc.device)

    def _body_core(self, enc, enc_len, minlen: int, ctc_logp, s: BeamState, att_state, step: int):
        """One beam step at ``step``."""
        K, W = self.K, self.W
        dev = enc.device
        lmax = s.alive_tokens.shape[1]
        # 1. full scorer
        att_logp, att_state = self.att_scorer.step(
            enc, enc_len, att_state, s.alive_tokens, s.alive_len, step
        )
        full = self.att_weight * att_logp
        # 2. pre-beam
        top_full, cand = torch.topk(full, W, dim=1)  # [K, W]
        if self.ctc_weight != 0.0 and self.eos < self.vocab_size:
            # eos is CTC-scored outside the pre-beam window too: append it
            # as a (W+1)-th candidate, masked when already in the top W
            has_eos = (cand == self.eos).any(dim=1, keepdim=True)
            eos_full = torch.where(has_eos, NEG_INF, full[:, self.eos : self.eos + 1])
            top_full = torch.cat([top_full, eos_full], dim=1)
            cand = torch.cat([cand, torch.full((K, 1), self.eos, dtype=cand.dtype, device=dev)], dim=1)
            W = W + 1
        # 3. CTC prefix rescoring with the absolute prefix score psi
        if self.ctc_weight != 0.0:
            psi = ctc_prefix_psi(ctc_logp, enc_len, s.ctc, cand,
                                 blank_id=self.blank_id, eos_id=self.eos)
            cand_score = s.alive_base[:, None] + top_full + self.ctc_weight * psi + self.penalty
        else:
            psi = torch.zeros((K, W), device=dev)
            cand_score = s.alive_score[:, None] + top_full + self.penalty

        # 4. top-K over all candidates, then eos selections retire
        new_score, flat_idx = _top_k(cand_score.reshape(-1), K)
        parent = torch.div(flat_idx, W, rounding_mode="floor")
        cidx = flat_idx % W
        token = cand[parent, cidx]
        ins = s.alive_len[parent]
        new_tokens = s.alive_tokens[parent]
        at_ins = torch.arange(lmax, device=dev)[None, :] == ins[:, None]
        new_tokens = torch.where(at_ins, token[:, None], new_tokens)
        new_len = ins + 1
        is_eos_sel = token == self.eos

        zeros = torch.zeros(K, device=dev)
        new_parts = s.alive_parts[parent] + torch.stack(
            [att_logp[parent, token], zeros, zeros, torch.ones(K, device=dev)], dim=1
        )
        if self.ctc_weight != 0.0:
            new_parts[:, 1] = psi[parent, cidx]

        # finished-buffer merge: eos hyps at/after minlen retire
        fin_cand = new_score.masked_fill(~(is_eos_sel & (step >= minlen)), NEG_INF)
        fin_top, fin_idx = _top_k(torch.cat([s.fin_score, fin_cand]), K)
        fin_tokens = torch.cat([s.fin_tokens, new_tokens])[fin_idx]
        fin_len = torch.cat([s.fin_len, new_len])[fin_idx]
        fin_parts = torch.cat([s.fin_parts, new_parts])[fin_idx]

        # 5. alive beam: eos slots are dead for the rest of the search
        new_score = new_score.masked_fill(is_eos_sel, NEG_INF)
        if self.ctc_weight != 0.0:
            new_base = (s.alive_base[parent] + top_full[parent, cidx] + self.penalty)
            new_base = new_base.masked_fill(is_eos_sel, NEG_INF)
            new_ctc = ctc_prefix_advance(ctc_logp, enc_len, s.ctc, token, parent,
                                         psi[parent, cidx], blank_id=self.blank_id)
        else:
            new_base = new_score
            new_ctc = s.ctc._replace(
                psi=psi[parent, cidx], last=token, r=s.ctc.r[parent],
                empty=torch.zeros(K, dtype=torch.bool, device=dev),
            )
        att_state = self.att_scorer.select(att_state, parent)
        return BeamState(
            step=step + 1,
            alive_tokens=new_tokens,
            alive_len=new_len,
            alive_score=new_score,
            alive_base=new_base,
            alive_parts=new_parts,
            ctc=new_ctc,
            fin_tokens=fin_tokens,
            fin_len=fin_len,
            fin_score=fin_top,
            fin_parts=fin_parts,
        ), att_state

    def _finalize(self, final: BeamState):
        """Merge still-alive hyps (maxlen reached) into the finished ones:
        append eos, keep the raw score."""
        lmax = final.alive_tokens.shape[1]
        at_end = torch.arange(lmax, device=final.alive_tokens.device)[None, :] == final.alive_len[:, None]
        alive_rows = final.alive_tokens.masked_fill(at_end, self.eos)
        top, idx = _top_k(torch.cat([final.fin_score, final.alive_score]), self.K)
        return (
            torch.cat([final.fin_tokens, alive_rows])[idx],
            torch.cat([final.fin_len, final.alive_len + 1])[idx],
            top,
            torch.cat([final.fin_parts, final.alive_parts])[idx],
        )

    # -- public API -----------------------------------------------------
    @torch.inference_mode()
    def __call__(
        self,
        enc: torch.Tensor,  # [1, T, D]
        enc_lens: torch.Tensor,  # [1]
        maxlenratio: float = 0.0,
        minlenratio: float = 0.0,
        nbest: int = 1,
    ) -> List[Hypothesis]:
        t_enc = int(enc.shape[1])
        enc_len = enc_lens[0]
        n_valid = int(enc_len)
        if maxlenratio == 0.0:
            maxlen = n_valid
        elif maxlenratio < 0.0:
            maxlen = int(-maxlenratio)
        else:
            maxlen = max(1, int(maxlenratio * n_valid))
        minlen = int(minlenratio * n_valid)
        lmax = self._lmax(t_enc, maxlenratio)
        ctc_logp = self._ctc_table(enc)
        s, att_state = self._init_carry(ctc_logp, enc, enc_len, lmax)
        limit = min(maxlen, lmax - 1)
        while s.step < limit and bool(s.alive_score.max() > s.fin_score.min()):
            s, att_state = self._body_core(enc, enc_len, minlen, ctc_logp, s, att_state, s.step)
        tokens, lens, scores, parts = (x.cpu() for x in self._finalize(s))
        return self._to_hyps(tokens, lens, scores, nbest, parts)

    @staticmethod
    def _lmax(t_enc: int, maxlenratio: float) -> int:
        """Token-buffer size: the output cap, not clamped to t_enc."""
        if maxlenratio < 0.0:
            bound = int(-maxlenratio)
        elif maxlenratio > 0.0:
            bound = int(maxlenratio * t_enc) + 1
        else:
            bound = t_enc
        return bound + 2

    def _to_hyps(self, tokens, lens, scores, nbest: int,
                 parts: Optional[torch.Tensor] = None) -> List[Hypothesis]:
        out = []
        for k in range(min(nbest, self.K)):
            if float(scores[k]) <= NEG_INF / 2:
                continue
            breakdown = {}
            if parts is not None:
                breakdown = {"decoder": float(parts[k, 0])}
                if self.ctc_weight != 0.0:
                    breakdown["ctc"] = float(parts[k, 1])
                if self.penalty != 0.0:
                    breakdown["length_bonus"] = float(parts[k, 3])
            out.append(Hypothesis(
                yseq=[int(t) for t in tokens[k, : int(lens[k])]],
                score=float(scores[k]),
                scores=breakdown,
            ))
        if not out:
            out = [Hypothesis(yseq=[self.sos, self.eos], score=float(scores[0]), scores={})]
        return out
