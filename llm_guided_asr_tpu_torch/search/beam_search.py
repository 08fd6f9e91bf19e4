"""Joint CTC/attention beam search on the device (counterpart of llm_guided_asr_tpu/search/beam_search.py).

Static-shape tensor steps over B lanes (utterances) of K hypotheses, one
Python iteration per output token:

- the full scorers score [B, K, V]: the attention decoder and, for shallow
  fusion, a language model (``lm_score_fn``, weighted by ``lm_weight``);
  a pre-beam keeps the W = int(pre_beam_ratio*K) best candidates of
  att_weight*att + lm_weight*lm per hypothesis, with eos appended as a
  (W+1)-th candidate so that it is always CTC-scored (as espnet does);
- the CTC prefix scorer rescores the candidates; scores use the absolute
  prefix probability psi: total = base + att_weight*att + lm_weight*lm +
  ctc_weight*psi + penalty, where base is the cumulative non-CTC part;
- top-K over each lane's candidates first, then the selected eos
  hypotheses retire into a fixed-size finished buffer (espnet
  beam_search.py:316 and post_process:500);
- a lane stops at its maxlen or when none of its alive hypotheses can beat
  its worst finished one; the loop reads one flag from the device per step
  (any lane still active) and moves the result to the host once at the end.

``__call__`` decodes one utterance (one lane).  ``batch_decode`` decodes a
batch in lockstep, as the JAX ``_vmapped_search`` does: one shared step
counter, per-lane maxlen and minlen, one body per step over [B, K], and the
search state of a lane that has stopped frozen by the per-lane active mask
while the scorer caches run on (their rows are never read again).  Each
lane's result is what a single-utterance call gives.

Weights follow asr_inference.py: decoder 1-ctc_weight, ctc ctc_weight,
lm lm_weight, length bonus penalty.  The attention scorer is the stateless
full-prefix one unless the caller passes another (the LLM-guided model's
cached scorer, the standard decoder's KV-cached one).

Streaming (``stream_start``, ``stream_step``, ``stream_hyps``; the
batch_beam_search_online analog) resumes one utterance's search as its
encoder buffer grows: the alive hypotheses' CTC rows are extended over the
new frames (ctc_prefix_extend) and the loop goes on from its step with a
larger frame budget; no token is decoded again.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from llm_guided_asr_tpu_torch.search.ctc_prefix import (
    CTCPrefixState,
    ctc_prefix_advance,
    ctc_prefix_extend,
    ctc_prefix_init,
    ctc_prefix_psi,
)
from llm_guided_asr_tpu_torch.search.scorers import StatelessAttScorer

NEG_INF = -1.0e10


class Hypothesis(NamedTuple):
    """Host-side result (espnet beam_search.py:15)."""

    yseq: List[int]
    score: float
    scores: Dict[str, float]


class BeamState(NamedTuple):
    step: int
    alive_tokens: torch.Tensor  # [B, K, Lmax] (sos at 0)
    alive_len: torch.Tensor  # [B, K]
    alive_score: torch.Tensor  # [B, K] total (= alive_base + ctc_weight * psi)
    alive_base: torch.Tensor  # [B, K] cumulative non-CTC part
    alive_parts: torch.Tensor  # [B, K, 4] unweighted (decoder, ctc, lm, length_bonus)
    ctc: CTCPrefixState
    fin_tokens: torch.Tensor  # [B, K, Lmax]
    fin_len: torch.Tensor  # [B, K]
    fin_score: torch.Tensor  # [B, K]
    fin_parts: torch.Tensor  # [B, K, 4]


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis, ties broken towards the lower index (as
    lax.top_k does) by a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _freeze(active: torch.Tensor, new, old):
    """``new`` where the lane is active, else ``old``, for every tensor of a
    BeamState (the CTC state included)."""
    def pick(n, o):
        return torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    fields = {}
    for name, n in new._asdict().items():
        o = getattr(old, name)
        if isinstance(n, CTCPrefixState):
            fields[name] = CTCPrefixState(*(pick(a, b) for a, b in zip(n, o)))
        elif isinstance(n, torch.Tensor):
            fields[name] = pick(n, o)
        else:
            fields[name] = n
    return BeamState(**fields)


class BatchBeamSearch:
    """Joint CTC/attention beam search over one utterance or a lockstep batch."""

    def __init__(
        self,
        model,
        vocab_size: int,
        sos: int,
        eos: int,
        beam_size: int = 10,
        ctc_weight: float = 0.5,
        penalty: float = 0.0,
        lm_score_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        lm_weight: float = 0.0,
        blank_id: int = 0,
        pre_beam_ratio: float = 1.5,
        att_scorer=None,
    ):
        """``lm_score_fn``: (tokens [N, L], lengths [N]) -> log-probs [N, V]
        of the next token (models/lm.py ``make_lm_score_fn``, the dense
        n-gram's ``make_score_fn``), added to the full score with
        ``lm_weight``."""
        self.model = model
        self.att_scorer = att_scorer or StatelessAttScorer(model)
        self.vocab_size = vocab_size
        self.sos = sos
        self.eos = eos
        # espnet clamps the beam to the vocabulary, and the pre-beam width
        # is int(ratio * K) capped at it (beam_search.py:105)
        self.K = min(beam_size, vocab_size)
        self.W = max(1, min(vocab_size, int(pre_beam_ratio * self.K)))
        self.ctc_weight = float(ctc_weight)
        self.att_weight = 1.0 - float(ctc_weight)
        self.penalty = float(penalty)
        self.lm_score_fn = lm_score_fn
        self.lm_weight = float(lm_weight)
        self.blank_id = blank_id

    @property
    def _use_lm(self) -> bool:
        return self.lm_score_fn is not None and self.lm_weight != 0.0

    # -- core loop ------------------------------------------------------
    def _init_carry(self, ctc_logp, enc, enc_lens, lmax: int, scorer_ctx=None):
        b, K, dev = enc.shape[0], self.K, enc.device
        first = torch.where(torch.arange(K, device=dev) == 0, 0.0, NEG_INF)[None].repeat(b, 1)
        init = BeamState(
            step=0,
            alive_tokens=torch.full((b, K, lmax), self.sos, dtype=torch.int64, device=dev),
            alive_len=torch.ones((b, K), dtype=torch.int64, device=dev),
            alive_score=first,
            alive_base=first.clone(),
            alive_parts=torch.zeros((b, K, 4), device=dev),
            ctc=ctc_prefix_init(ctc_logp, enc_lens, K, self.blank_id),
            fin_tokens=torch.zeros((b, K, lmax), dtype=torch.int64, device=dev),
            fin_len=torch.zeros((b, K), dtype=torch.int64, device=dev),
            fin_score=torch.full((b, K), NEG_INF, device=dev),
            fin_parts=torch.zeros((b, K, 4), device=dev),
        )
        return init, self.att_scorer.init(enc, enc_lens, K, lmax, ctx=scorer_ctx)

    def _ctc_table(self, enc):
        """[B, T, V] CTC log-probs of each lane (zeros, never read, without CTC)."""
        if self.ctc_weight == 0.0:
            return torch.zeros((*enc.shape[:2], self.vocab_size), device=enc.device)
        logp = self.model.ctc_log_softmax(enc)
        if logp.shape[-1] != self.vocab_size:
            raise ValueError(
                f"the CTC head has {logp.shape[-1]} outputs but the search scores "
                f"{self.vocab_size} tokens: a mixed-vocab CTC cannot score the decoder's "
                f"candidates (decode it with ctc_weight=0)")
        return logp

    def _body_core(self, enc, enc_lens, minlens, ctc_logp, s: BeamState, att_state, step: int):
        """One beam step at ``step`` for every lane."""
        K, W = self.K, self.W
        b, dev = enc.shape[0], enc.device
        lmax = s.alive_tokens.shape[2]
        lanes = torch.arange(b, device=dev)[:, None]
        # 1. full scorers over the B*K rows
        rows, row_lens = s.alive_tokens.reshape(b * K, lmax), s.alive_len.reshape(b * K)
        att_logp, att_state = self.att_scorer.step(enc, enc_lens, att_state, rows, row_lens, step)
        att_logp = att_logp.reshape(b, K, -1)
        full = self.att_weight * att_logp
        lm_logp = None
        if self._use_lm:
            lm_logp = self.lm_score_fn(rows, row_lens).reshape(b, K, -1)
            full = full + self.lm_weight * lm_logp
        # 2. pre-beam
        top_full, cand = torch.topk(full, W, dim=2)  # [B, K, W]
        if self.ctc_weight != 0.0 and self.eos < self.vocab_size:
            # eos is CTC-scored outside the pre-beam window too: append it
            # as a (W+1)-th candidate, masked when already in the top W
            has_eos = (cand == self.eos).any(dim=2, keepdim=True)
            eos_full = torch.where(has_eos, NEG_INF, full[..., self.eos : self.eos + 1])
            top_full = torch.cat([top_full, eos_full], dim=2)
            cand = torch.cat([cand, torch.full((b, K, 1), self.eos, dtype=cand.dtype, device=dev)],
                             dim=2)
            W = W + 1
        # 3. CTC prefix rescoring with the absolute prefix score psi
        if self.ctc_weight != 0.0:
            psi = ctc_prefix_psi(ctc_logp, enc_lens, s.ctc, cand,
                                 blank_id=self.blank_id, eos_id=self.eos)
            cand_score = s.alive_base[..., None] + top_full + self.ctc_weight * psi + self.penalty
        else:
            psi = torch.zeros((b, K, W), device=dev)
            cand_score = s.alive_score[..., None] + top_full + self.penalty

        # 4. top-K over each lane's candidates, then eos selections retire
        new_score, flat_idx = _top_k(cand_score.reshape(b, -1), K)
        parent = torch.div(flat_idx, W, rounding_mode="floor")
        token = torch.gather(cand.reshape(b, -1), 1, flat_idx)
        ins = torch.gather(s.alive_len, 1, parent)
        new_tokens = s.alive_tokens[lanes, parent]
        at_ins = torch.arange(lmax, device=dev)[None, None, :] == ins[..., None]
        new_tokens = torch.where(at_ins, token[..., None], new_tokens)
        new_len = ins + 1
        is_eos_sel = token == self.eos
        psi_sel = torch.gather(psi.reshape(b, -1), 1, flat_idx)

        zeros = torch.zeros((b, K), device=dev)
        lm_part = lm_logp[lanes, parent, token] if lm_logp is not None else zeros
        new_parts = s.alive_parts[lanes, parent] + torch.stack(
            [att_logp[lanes, parent, token], zeros, lm_part, torch.ones((b, K), device=dev)], dim=2
        )
        if self.ctc_weight != 0.0:
            new_parts[..., 1] = psi_sel

        # finished-buffer merge: eos hyps at/after the lane's minlen retire
        fin_cand = new_score.masked_fill(~(is_eos_sel & (step >= minlens[:, None])), NEG_INF)
        fin_top, fin_idx = _top_k(torch.cat([s.fin_score, fin_cand], dim=1), K)
        fin_tokens = torch.cat([s.fin_tokens, new_tokens], dim=1)[lanes, fin_idx]
        fin_len = torch.gather(torch.cat([s.fin_len, new_len], dim=1), 1, fin_idx)
        fin_parts = torch.cat([s.fin_parts, new_parts], dim=1)[lanes, fin_idx]

        # 5. alive beam: eos slots are dead for the rest of the search
        new_score = new_score.masked_fill(is_eos_sel, NEG_INF)
        if self.ctc_weight != 0.0:
            new_base = (torch.gather(s.alive_base, 1, parent)
                        + torch.gather(top_full.reshape(b, -1), 1, flat_idx) + self.penalty)
            new_base = new_base.masked_fill(is_eos_sel, NEG_INF)
            new_ctc = ctc_prefix_advance(ctc_logp, enc_lens, s.ctc, token, parent, psi_sel,
                                         blank_id=self.blank_id)
        else:
            new_base = new_score
            new_ctc = s.ctc._replace(
                psi=psi_sel, last=token, r=s.ctc.r[lanes, parent],
                empty=torch.zeros((b, K), dtype=torch.bool, device=dev),
            )
        att_state = self.att_scorer.select(att_state, (lanes * K + parent).reshape(-1))
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

    def _finalize(self, final: BeamState) -> torch.Tensor:
        """Merge each lane's still-alive hyps (maxlen reached) into its
        finished ones (eos appended, raw score kept); returns one float64
        tensor [B, K, Lmax + 6] of (tokens, length, score, 4 parts), exact
        for every field, so that the result reaches the host in one copy."""
        b, _, lmax = final.alive_tokens.shape
        lanes = torch.arange(b, device=final.alive_tokens.device)[:, None]
        at_end = torch.arange(lmax, device=lanes.device)[None, None, :] == final.alive_len[..., None]
        alive_rows = final.alive_tokens.masked_fill(at_end, self.eos)
        top, idx = _top_k(torch.cat([final.fin_score, final.alive_score], dim=1), self.K)
        tokens = torch.cat([final.fin_tokens, alive_rows], dim=1)[lanes, idx]
        lens = torch.gather(torch.cat([final.fin_len, final.alive_len + 1], dim=1), 1, idx)
        parts = torch.cat([final.fin_parts, final.alive_parts], dim=1)[lanes, idx]
        return torch.cat([tokens.double(), lens[..., None].double(), top[..., None].double(),
                          parts.double()], dim=2)

    def _run_loop(self, enc, enc_lens, maxlens, minlens, carry, ctc_logp):
        """Steps of the lockstep loop from ``carry`` (BeamState, scorer
        state) while a lane is active: below its maxlen (and lmax - 1) with
        an alive hypothesis that beats its worst finished one."""
        s, att_state = carry
        limit = torch.clamp(maxlens, max=s.alive_tokens.shape[2] - 1)
        while True:
            viable = s.alive_score.max(dim=1).values > s.fin_score.min(dim=1).values
            active = (s.step < limit) & viable
            if not bool(active.any()):  # the one host read of the step
                break
            new, att_state = self._body_core(enc, enc_lens, minlens, ctc_logp, s, att_state,
                                             s.step)
            s = new if enc.shape[0] == 1 else _freeze(active, new, s)
        return s, att_state

    def _search(self, enc, enc_lens, maxlens, minlens, lmax: int, scorer_ctx=None) -> np.ndarray:
        """The lockstep loop over the lanes; returns _finalize's tensor on the host."""
        ctc_logp = self._ctc_table(enc)
        carry = self._init_carry(ctc_logp, enc, enc_lens, lmax, scorer_ctx)
        s, _ = self._run_loop(enc, enc_lens, maxlens, minlens, carry, ctc_logp)
        return self._finalize(s).cpu().numpy()

    def _length_bounds(self, enc_lens: torch.Tensor, maxlenratio: float, minlenratio: float):
        """Per-lane (maxlen, minlen) [B], in float32 as the JAX search
        computes them: maxlenratio 0 decodes up to the valid frames, < 0 a
        fixed -maxlenratio tokens, > 0 that ratio of the frames (at least 1)."""
        if maxlenratio == 0.0:
            maxlens = enc_lens
        elif maxlenratio < 0.0:
            maxlens = torch.full_like(enc_lens, int(-maxlenratio))
        else:
            maxlens = torch.clamp((maxlenratio * enc_lens.float()).long(), min=1)
        return maxlens, (minlenratio * enc_lens.float()).long()

    def _decode(self, encs, enc_lens, maxlenratio, minlenratio, nbest, scorer_ctx=None):
        enc_lens = enc_lens.reshape(-1).long()
        maxlens, minlens = self._length_bounds(enc_lens, maxlenratio, minlenratio)
        out = self._search(encs, enc_lens, maxlens, minlens,
                           self._lmax(int(encs.shape[1]), maxlenratio), scorer_ctx)
        return self._lanes_to_hyps(out, nbest)

    @torch.inference_mode()
    def rescore(self, enc: torch.Tensor, enc_lens: torch.Tensor, yseq: Sequence[int],
                maxlenratio: float = 0.0) -> float:
        """The score this search gives the hypothesis ``yseq`` ([sos, y...,
        eos], or a prefix [sos, y...] as the beam ranks it) of one utterance
        (enc [1, T, D]), its tokens forced through the scorers one step at a
        time: the attention log-probs (and the LM's) with their weights and
        the penalty, plus ``ctc_weight`` times the CTC prefix score of the
        whole prefix (for eos, of the complete sequence).  A hypothesis as
        long as the search lets one grow was merged without its eos scored,
        and is rescored so.  It arbitrates a hypothesis that another search
        (in another dtype) found."""
        enc_lens = enc_lens.reshape(-1).long()
        lmax = self._lmax(int(enc.shape[1]), maxlenratio)
        limit = min(int(self._length_bounds(enc_lens, maxlenratio, 0.0)[0][0]), lmax - 1)
        if list(yseq[:1]) != [self.sos]:
            raise ValueError(f"rescore: {list(yseq)} does not start with sos")
        merged = yseq[-1] == self.eos and len(yseq) - 2 == limit
        tokens = list(yseq[1:-1]) if merged else list(yseq[1:])
        dev = enc.device
        ctc_logp = self._ctc_table(enc)
        att_state = self.att_scorer.init(enc, enc_lens, 1, lmax)
        ctc = ctc_prefix_init(ctc_logp, enc_lens, 1, self.blank_id)
        rows = torch.full((1, lmax), self.sos, dtype=torch.int64, device=dev)
        base, psi = 0.0, 0.0
        for step, token in enumerate(tokens):
            lens = torch.full((1,), step + 1, dtype=torch.int64, device=dev)
            att_logp, att_state = self.att_scorer.step(enc, enc_lens, att_state, rows, lens, step)
            base += self.att_weight * float(att_logp[0, token]) + self.penalty
            if self._use_lm:
                base += self.lm_weight * float(self.lm_score_fn(rows, lens)[0, token])
            if self.ctc_weight != 0.0:
                cand = torch.full((1, 1), token, dtype=torch.int64, device=dev)
                psi_t = ctc_prefix_psi(ctc_logp, enc_lens, ctc, cand[:, :, None],
                                       blank_id=self.blank_id, eos_id=self.eos)[:, :, 0]
                psi = float(psi_t[0, 0])
                if token != self.eos:
                    ctc = ctc_prefix_advance(ctc_logp, enc_lens, ctc, cand,
                                             torch.zeros_like(cand), psi_t, self.blank_id)
            rows[0, step + 1] = token
        return base + self.ctc_weight * psi

    def _lanes_to_hyps(self, out: np.ndarray, nbest: int) -> List[List[Hypothesis]]:
        """_finalize's [B, K, Lmax + 6] host array -> each lane's hypotheses."""
        lmax = out.shape[2] - 6
        return [self._to_hyps(lane[:, :lmax].astype(np.int64), lane[:, lmax].astype(np.int64),
                              lane[:, lmax + 1].astype(np.float32), nbest, lane[:, lmax + 2:])
                for lane in out]

    # -- streaming continuation (batch_beam_search_online analog) --------
    # One utterance (one lane).  The JAX package's _sync_stream_weights
    # only drops jit caches when the weights object is swapped; the port
    # compiles nothing, so it has no counterpart.
    @staticmethod
    def _one_lane(x) -> torch.Tensor:
        return torch.as_tensor(x).reshape(1).long()

    @torch.inference_mode()
    def stream_start(self, ctc_logp: torch.Tensor, enc_buf: torch.Tensor, enc_len, lmax: int,
                     scorer_ctx=None) -> Tuple[BeamState, Dict]:
        """The initial resumable carry over a partly filled encoder buffer:
        ctc_logp [T, V] and enc_buf [1, T, D] are the buffers at their full
        capacity T, enc_len the frames filled so far."""
        enc_len = self._one_lane(enc_len).to(enc_buf.device)
        return self._init_carry(ctc_logp[None], enc_buf, enc_len, lmax, scorer_ctx)

    @torch.inference_mode()
    def stream_step(self, enc_buf: torch.Tensor, enc_len_old, enc_len_new, maxlen, minlen,
                    carry, ctc_logp: torch.Tensor):
        """Extend the CTC rows over frames [enc_len_old, enc_len_new), then
        go on with the search up to ``maxlen`` tokens; returns the carry."""
        dev = enc_buf.device
        old, new = self._one_lane(enc_len_old).to(dev), self._one_lane(enc_len_new).to(dev)
        state, att_state = carry
        if self.ctc_weight != 0.0:
            state = state._replace(ctc=ctc_prefix_extend(state.ctc, ctc_logp[None], old, new,
                                                         self.blank_id))
        return self._run_loop(enc_buf, new, self._one_lane(maxlen).to(dev),
                              self._one_lane(minlen).to(dev), (state, att_state), ctc_logp[None])

    @torch.inference_mode()
    def stream_hyps(self, carry, nbest: int = 1) -> List[Hypothesis]:
        """The best hypotheses (partial or final) of a resumable carry."""
        return self._lanes_to_hyps(self._finalize(carry[0]).cpu().numpy(), nbest)[0]

    # -- public API -----------------------------------------------------
    @torch.inference_mode()
    def __call__(
        self,
        enc: torch.Tensor,  # [1, T, D]
        enc_lens: torch.Tensor,  # [1]
        maxlenratio: float = 0.0,
        minlenratio: float = 0.0,
        nbest: int = 1,
        scorer_ctx=None,  # per-utterance scorer context (the guided scorer's bias ids)
    ) -> List[Hypothesis]:
        """Decode one utterance."""
        return self._decode(enc, enc_lens, maxlenratio, minlenratio, nbest, scorer_ctx)[0]

    @torch.inference_mode()
    def batch_decode(
        self,
        encs: torch.Tensor,  # [B, T, D]
        enc_lens: torch.Tensor,  # [B]
        maxlenratio: float = 0.0,
        minlenratio: float = 0.0,
        nbest: int = 1,
    ) -> List[List[Hypothesis]]:
        """Decode a batch of utterances in one lockstep search."""
        return self._decode(encs, enc_lens, maxlenratio, minlenratio, nbest)

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
                 parts: Optional[np.ndarray] = None) -> List[Hypothesis]:
        out = []
        for k in range(min(nbest, self.K)):
            if float(scores[k]) <= NEG_INF / 2:
                continue
            breakdown = {}
            if parts is not None:
                breakdown = {"decoder": float(parts[k, 0])}
                if self.ctc_weight != 0.0:
                    breakdown["ctc"] = float(parts[k, 1])
                if self._use_lm:
                    breakdown["lm"] = float(parts[k, 2])
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
