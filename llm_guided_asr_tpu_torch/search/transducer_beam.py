"""Transducer beam search over one utterance (counterpart of llm_guided_asr_tpu/search/transducer_beam.py).

The mAES-style fixed-expansion beam: at each encoder frame every
hypothesis gets up to ``max_sym_exp`` expansion rounds; in a round it
either settles (takes blank, fixing its score for the frame) or emits one
of its top non-blank tokens, and the K best of the K settled and K*W
emitted candidates go on.  All K hypotheses are fixed-shape tensors; the
prediction network is recomputed over the whole label prefix (capped at
``u_max``) in every round.  Both top-k steps break ties towards the lower
index, as lax.top_k does, and the final order is a stable sort.
``transducer_alsd_decode`` is the alignment-length synchronous search.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from llm_guided_asr_tpu_torch.search.beam_search import Hypothesis, _top_k

NEG_INF = -1.0e10


def transducer_beam_decode(model, enc: torch.Tensor, enc_lens: torch.Tensor, beam_size: int = 5,
                           max_sym_exp: int = 2, u_max: int = 200, nbest: int = 1,
                           score_norm: bool = True) -> List[Hypothesis]:
    """Beam decode one utterance (enc [1, T, D], enc_lens [1]); returns
    the ``nbest`` best hypotheses, scores normalized by the label count
    plus one (the blank context) when ``score_norm``.  Frames past
    enc_lens[0] leave the beam as it is, so the loop stops there (one host
    read of the length)."""
    t_max = enc.shape[1]
    u_max = min(u_max, t_max * max_sym_exp + 1)
    K = beam_size
    blank = model.cfg.blank_id
    dev = enc.device
    enc_len = int(enc_lens[0])
    rows = torch.arange(K, device=dev)
    pos = torch.arange(u_max, device=dev)

    tokens = torch.zeros((K, u_max), dtype=torch.long, device=dev)
    n = torch.zeros(K, dtype=torch.long, device=dev)
    score = torch.where(rows == 0, 0.0, NEG_INF)
    for t in range(min(t_max, enc_len)):
        h_k = enc[0, t][None, :].expand(K, -1)
        active = torch.ones(K, dtype=torch.bool, device=dev)
        for e in range(max_sym_exp):
            g = model.decode_labels(tokens)[rows, n]  # [K, H] at each prefix's end
            logp = F.log_softmax(model.joint_step(h_k, g).float(), dim=-1)  # [K, V]
            # active hypotheses settle by taking blank; settled ones keep their score
            settled = torch.where(active, score + logp[:, blank], score)
            if e == max_sym_exp - 1:
                score = settled
                break
            w = min(K, logp.shape[-1] - 1)
            top_lp, top_id = _top_k(logp.index_fill(1, torch.tensor([blank], device=dev),
                                                    NEG_INF), w)  # [K, W]
            emit = torch.where((active & (n < u_max - 1))[:, None], score[:, None] + top_lp,
                               NEG_INF)
            best, idx = _top_k(torch.cat([settled, emit.reshape(-1)]), K)
            is_settled = idx < K
            parent = torch.where(is_settled, idx, (idx - K) // w)
            new_token = top_id[parent, (idx - K).clamp(0, K * w - 1) % w]
            tokens = torch.where(~is_settled[:, None] & (pos[None, :] == n[parent][:, None]),
                                 new_token[:, None], tokens[parent])
            n = torch.where(is_settled, n[parent], (n[parent] + 1).clamp(max=u_max - 1))
            active = active[parent] & ~is_settled
            score = best
    final = score / (n + 1) if score_norm else score
    order = torch.argsort(-final, stable=True)
    tk, nn, ss = tokens[order].tolist(), n[order].tolist(), final[order].tolist()
    out = [Hypothesis(yseq=tk[k][: nn[k]], score=ss[k], scores={})
           for k in range(min(nbest, K)) if ss[k] > NEG_INF / 2]
    return out or [Hypothesis(yseq=[], score=ss[0], scores={})]


def transducer_alsd_decode(model, enc: torch.Tensor, enc_lens: torch.Tensor, beam_size: int = 5,
                           u_max: int = 50, nbest: int = 1,
                           score_norm: bool = True) -> List[Hypothesis]:
    """Alignment-length synchronous decoding (Saon et al. 2020;
    beam_search_transducer.py align_length_sync_decoding) of one utterance.

    One loop over the alignment length i = t + u: every live hypothesis
    sits at its own frame t = i - u; a blank advances t, a label u, so
    hypotheses of different lengths compete in one top-K.  A blank that
    crosses the last frame retires the hypothesis into a finished buffer,
    merged by a top-K over its K entries and the K new ones.  The token
    table is min(u_max, T) + 1 wide.  Past i = enc_len + min(u_max, T) no
    hypothesis is live and nothing changes, so the loop stops there.
    Scores are normalized as in :func:`transducer_beam_decode`."""
    t_max = enc.shape[1]
    K = beam_size
    blank = model.cfg.blank_id
    dev = enc.device
    enc_len = int(enc_lens[0])
    um = min(u_max, t_max)
    width = um + 1
    rows = torch.arange(K, device=dev)
    pos = torch.arange(width, device=dev)
    blank_col = torch.tensor([blank], device=dev)

    tokens = torch.zeros((K, width), dtype=torch.long, device=dev)
    u = torch.zeros(K, dtype=torch.long, device=dev)
    score = torch.where(rows == 0, 0.0, NEG_INF)
    fin_tokens, fin_u = tokens.clone(), u.clone()
    fin_score = torch.full((K,), NEG_INF, device=dev)
    for i in range(min(t_max + um, enc_len + um)):
        t = i - u  # [K] each hypothesis's frame
        live = (t >= 0) & (t < enc_len) & (score > NEG_INF / 2)
        g = model.decode_labels(tokens)[rows, u]
        logits = model.joint_step(enc[0, t.clamp(0, t_max - 1)], g)
        logp = F.log_softmax(logits.float(), dim=-1)
        blank_score = torch.where(live, score + logp[:, blank], NEG_INF)
        final = live & (t + 1 >= enc_len)
        fin_score, fi = _top_k(torch.cat([fin_score, torch.where(final, blank_score, NEG_INF)]),
                               K)
        fin_tokens = torch.cat([fin_tokens, tokens])[fi]
        fin_u = torch.cat([fin_u, u])[fi]
        w = min(K, logp.shape[-1] - 1)
        top_lp, top_id = _top_k(logp.index_fill(1, blank_col, NEG_INF), w)
        emit = torch.where((live & (u < width - 1))[:, None], score[:, None] + top_lp, NEG_INF)
        best, idx = _top_k(torch.cat([torch.where(final, NEG_INF, blank_score),
                                      emit.reshape(-1)]), K)
        is_blank = idx < K
        parent = torch.where(is_blank, idx, (idx - K) // w)
        new_token = top_id[parent, (idx - K).clamp(0, K * w - 1) % w]
        tokens = torch.where(~is_blank[:, None] & (pos[None, :] == u[parent][:, None]),
                             new_token[:, None], tokens[parent])
        u = torch.where(is_blank, u[parent], (u[parent] + 1).clamp(max=width - 1))
        score = best
    final_score = fin_score / (fin_u + 1) if score_norm else fin_score
    order = torch.argsort(-final_score, stable=True)
    tk, nn, ss = fin_tokens[order].tolist(), fin_u[order].tolist(), final_score[order].tolist()
    out = [Hypothesis(yseq=tk[k][: nn[k]], score=ss[k], scores={})
           for k in range(min(nbest, K)) if ss[k] > NEG_INF / 2]
    return out or [Hypothesis(yseq=[], score=ss[0], scores={})]
