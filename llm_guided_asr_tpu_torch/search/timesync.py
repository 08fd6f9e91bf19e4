"""Frame-synchronous CTC beam search (counterpart of llm_guided_asr_tpu/search/timesync.py).

espnet/nets/beam_search_timesync.py: the search advances over encoder
frames, not output tokens.  Each frame updates K alive prefixes' blank and
non-blank CTC mass and proposes single-token extensions; the top K of the
K stays and K*V extensions by total mass survive (ties to the lower index,
as lax.top_k breaks them).  The attention decoder, when ``att_weight`` >
0, rescores the K finalists once at the end, teacher-forced over
[sos, y, eos].

As in the JAX search, two candidate paths that collapse to the same prefix
in the same frame are not merged: their mass stays on separate slots.

The JAX rescoring scores the token after y as the pad id 0 and places eos
one position later, outside the scored range (``timesync.py:133-142``);
the port scores eos there.  With ``att_weight`` 0 (the default) both
compute the same thing.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from llm_guided_asr_tpu_torch.search.beam_search import _top_k

NEG_INF = -1.0e10


class TimesyncHypothesis(NamedTuple):
    yseq: List[int]
    score: float
    scores: dict


class CTCBeamSearchTimesync:
    def __init__(self, model, vocab_size: int, sos: int, eos: int, beam_size: int = 10,
                 blank_id: int = 0, ctc_weight: float = 1.0, att_weight: float = 0.0):
        self.model = model
        self.vocab_size = vocab_size
        self.sos = sos
        self.eos = eos
        self.K = min(beam_size, vocab_size)
        self.blank_id = blank_id
        self.ctc_weight = float(ctc_weight)
        self.att_weight = float(att_weight)

    def _search(self, enc, enc_len: int, lmax: int):
        K, V = self.K, self.vocab_size
        logp = self.model.ctc_log_softmax(enc)[0]  # [T, V]
        dev = logp.device
        slots = torch.arange(K, device=dev)
        vocab = torch.arange(V, device=dev)
        tokens = torch.zeros((K, lmax), dtype=torch.int64, device=dev)
        lens = torch.zeros((K,), dtype=torch.int64, device=dev)
        # slot 0 is the empty prefix with p_b = 0; the other slots are dead
        p_b = torch.where(slots == 0, 0.0, NEG_INF)
        p_nb = torch.full((K,), NEG_INF, device=dev)
        for t in range(logp.shape[0]):
            x = logp[t]
            last = tokens[slots, torch.clamp(lens - 1, min=0)]
            has_last = lens > 0
            total = torch.logaddexp(p_b, p_nb)
            # the same prefix after this frame
            stay_b = total + x[self.blank_id]
            stay_nb = torch.where(has_last, p_nb + x[torch.clamp(last, 0, V - 1)], NEG_INF)
            # extend g by c != blank: p_nb(g.c) = (c == last(g) ? p_b : total) + x[c]
            repeat = (vocab[None, :] == last[:, None]) & has_last[:, None]
            ext_nb = torch.where(repeat, p_b[:, None], total[:, None]) + x[None, :]
            ext_nb[:, self.blank_id] = NEG_INF
            if t >= enc_len:  # frames past the valid ones change nothing
                ext_nb = torch.full_like(ext_nb, NEG_INF)
                stay_b, stay_nb = p_b, p_nb
            stay_total = torch.logaddexp(stay_b, stay_nb)
            _, idx = _top_k(torch.cat([stay_total, ext_nb.reshape(-1)]), K)
            is_stay = idx < K
            src = torch.where(is_stay, idx, torch.div(idx - K, V, rounding_mode="floor"))
            tok = torch.where(is_stay, 0, (idx - K) % V)
            new_tokens, new_lens = tokens[src], lens[src]
            ins = torch.where(is_stay, -1, new_lens)  # -1: nothing written
            at_ins = torch.arange(lmax, device=dev)[None, :] == ins[:, None]
            tokens = torch.where(at_ins, tok[:, None], new_tokens)
            lens = torch.where(is_stay, new_lens, torch.clamp(new_lens + 1, max=lmax))
            p_b, p_nb = (torch.where(is_stay, stay_b[src], NEG_INF),
                         torch.where(is_stay, stay_nb[src],
                                     ext_nb.reshape(-1)[torch.clamp(idx - K, min=0)]))
        ctc_scores = torch.logaddexp(p_b, p_nb)

        att_scores = torch.zeros((K,), device=dev)
        if self.att_weight > 0.0:
            # the K finalists teacher-forced once: inputs [sos, y], targets [y, eos]
            ys = torch.cat([torch.full((K, 1), self.sos, dtype=torch.int64, device=dev), tokens], 1)
            pos = torch.arange(ys.shape[1], device=dev)[None, :]
            ys_out = torch.cat([tokens, torch.zeros((K, 1), dtype=torch.int64, device=dev)], 1)
            ys_out = torch.where(pos == lens[:, None], self.eos, ys_out)
            logits = self.model.decoder_logits(enc.expand(K, -1, -1),
                                               torch.full((K,), enc_len, device=dev), ys, lens + 1)
            lp = torch.log_softmax(logits.float(), dim=-1)
            tok_lp = torch.gather(lp, 2, ys_out[..., None])[..., 0]
            att_scores = torch.where(pos <= lens[:, None], tok_lp, torch.zeros_like(tok_lp)).sum(1)

        final = self.ctc_weight * ctc_scores + self.att_weight * att_scores
        order = torch.sort(-final, stable=True).indices
        return tokens[order], lens[order], final[order], ctc_scores[order], att_scores[order]

    @torch.inference_mode()
    def __call__(self, enc: torch.Tensor, enc_lens: torch.Tensor,
                 nbest: int = 1) -> List[TimesyncHypothesis]:
        """enc [1, T, D], enc_lens [1] -> the nbest hypotheses (no sos/eos)."""
        out = self._search(enc, int(enc_lens.reshape(-1)[0]), int(enc.shape[1]) + 1)
        tokens, lens, final, ctc_s, att_s = (x.cpu().numpy() for x in out)
        hyps = [TimesyncHypothesis(yseq=[int(t) for t in tokens[k, : lens[k]]],
                                   score=float(final[k]),
                                   scores={"ctc": float(ctc_s[k]), "decoder": float(att_s[k])})
                for k in range(min(nbest, self.K)) if final[k] > NEG_INF / 2]
        return hyps or [TimesyncHypothesis([], float(final[0]), {})]
