"""TSD, NSC and multi-blank transducer searches (counterpart of llm_guided_asr_tpu/search/transducer_extra.py).

The remaining searches of the reference's beam_search_transducer.py:

- time-synchronous decoding (time_sync_decoding, Saon et al. 2020): per
  frame up to ``max_sym_exp`` expansion rounds; blank-settled hypotheses
  gather in a per-frame buffer where identical label sequences log-add;
- N-step constrained beam search (nsc_beam_search, Kim et al. 2020):
  ``nstep`` constrained rounds a frame with the reference's subtract()
  de-duplication, after the prefix-search score augmentation (a
  hypothesis that extends another live one by at most ``prefix_alpha``
  labels absorbs the probability of being reached through it at this
  frame);
- the multi-blank greedy search (multi_blank_greedy_search, Xu et al.
  2023): a big blank ends the frame and skips its duration in frames.

Every buffer is a fixed-shape tensor ([K, U] token table, [K] lengths and
scores), as in the JAX package; the prediction network runs over the
whole label prefix in every round.  Every top-k and sort breaks ties
towards the lower index, as lax does; ``argmax``/``argmin`` take the first.
Like the JAX package, NSC recombines identical label sequences in its
settled set with log-sum-exp where the reference keeps both: a prefix
reached along several paths can score slightly higher, in one slot.
TSD and NSC report the raw score of each hypothesis, sorted by the score
divided by its length + 1 (the reference's sort_nbest);
``transducer_beam_decode`` and ALSD report the divided score itself.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from llm_guided_asr_tpu_torch.search.beam_search import Hypothesis, _top_k

NEG_INF = -1.0e10

Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # tokens [K, U], lengths [K], scores [K]


def _same_prefix(tok_a, n_a, tok_b, n_b) -> torch.Tensor:
    """[KA, U] x [KB, U] -> [KA, KB]: identical label sequences."""
    pos = torch.arange(tok_a.shape[1], device=tok_a.device)
    in_len = pos[None, None, :] < n_a[:, None, None]
    eq = torch.where(in_len, tok_a[:, None, :] == tok_b[None, :, :], True)
    return (n_a[:, None] == n_b[None, :]) & eq.all(dim=-1)


def _empty(K: int, u_max: int, dev) -> Rows:
    return (torch.zeros((K, u_max), dtype=torch.long, device=dev),
            torch.zeros(K, dtype=torch.long, device=dev), torch.full((K,), NEG_INF, device=dev))


def _merge_rows(buf: Rows, cand: Rows) -> Rows:
    """Insert the K candidate rows into the K-slot buffer one at a time: an
    identical live prefix log-adds its score, a new one evicts the lowest
    slot if it beats it (a streaming top-K)."""
    tok, n, s = buf
    c_tok, c_n, c_s = cand
    slots = torch.arange(tok.shape[0], device=tok.device)
    for i in range(c_s.shape[0]):
        same = _same_prefix(c_tok[i][None], c_n[i][None], tok, n)[0] & (s > NEG_INF / 2)
        alive = c_s[i] > NEG_INF / 2
        hit = same.any() & alive
        j_min = torch.argmin(s)
        take_new = alive & ~hit & (c_s[i] > s[j_min])
        j = torch.where(hit, torch.argmax(torch.where(same, s, NEG_INF)), j_min)
        row = slots == j
        tok = torch.where((row & take_new)[:, None], c_tok[i][None, :], tok)
        n = torch.where(row & take_new, c_n[i], n)
        new_val = torch.where(hit, torch.logaddexp(s[j], c_s[i]), c_s[i])
        s = torch.where(row & (hit | take_new), new_val, s)
    return tok, n, s


def _expand_topk(c: Rows, logp: torch.Tensor, blank: int, u_max: int, dup_mask=None) -> Rows:
    """One constrained expansion: each live row's top-W non-blank tokens,
    the K best of the K x W candidates; ``dup_mask`` [K, W] drops
    candidates (NSC's subtract())."""
    c_tok, c_n, c_s = c
    K = c_s.shape[0]
    w = min(K, logp.shape[-1] - 1)
    top_lp, top_id = _top_k(logp.index_fill(1, torch.tensor([blank], device=logp.device),
                                            NEG_INF), w)
    emit = torch.where(((c_s > NEG_INF / 2) & (c_n < u_max - 1))[:, None],
                       c_s[:, None] + top_lp, NEG_INF)
    if dup_mask is not None:
        emit = torch.where(dup_mask, NEG_INF, emit)
    best, idx = _top_k(emit.reshape(-1), K)
    parent = idx // w
    ins = c_n[parent]
    pos = torch.arange(u_max, device=c_tok.device)
    new_tok = torch.where(pos[None, :] == ins[:, None], top_id[parent, idx % w][:, None],
                          c_tok[parent])
    return new_tok, (ins + 1).clamp(max=u_max - 1), best


def _start(K: int, u_max: int, dev) -> Rows:
    return (torch.zeros((K, u_max), dtype=torch.long, device=dev),
            torch.zeros(K, dtype=torch.long, device=dev),
            torch.where(torch.arange(K, device=dev) == 0, 0.0, NEG_INF))


def _round(model, h_k: torch.Tensor, c: Rows) -> torch.Tensor:
    """The joint's log-probs [K, V] after each row's prefix at frame h_k."""
    c_tok, c_n, _ = c
    g = model.decode_labels(c_tok)[torch.arange(c_n.shape[0], device=c_n.device), c_n]
    return F.log_softmax(model.joint_step(h_k, g).float(), dim=-1)


def _collect(rows: Rows, nbest: int, score_norm: bool) -> List[Hypothesis]:
    """The reference's sort_nbest: sorted by score / (length + 1) (the
    blank context counts), the raw score reported."""
    tokens, n, score = rows
    final = score / (n + 1) if score_norm else score
    order = torch.argsort(-final, stable=True)
    tk, nn, ss = tokens[order].tolist(), n[order].tolist(), score[order].tolist()
    out = [Hypothesis(yseq=tk[k][: nn[k]], score=ss[k], scores={})
           for k in range(min(nbest, len(ss))) if ss[k] > NEG_INF / 2]
    return out or [Hypothesis(yseq=[], score=ss[0], scores={})]


def transducer_tsd_decode(model, enc: torch.Tensor, enc_lens: torch.Tensor, beam_size: int = 5,
                          max_sym_exp: int = 2, u_max: int = 200, nbest: int = 1,
                          score_norm: bool = True) -> List[Hypothesis]:
    """Time-synchronous decoding of one utterance (enc [1, T, D]); the token
    table is min(u_max, T * max(max_sym_exp - 1, 1) + 1) wide.  Frames past
    enc_lens[0] change nothing, so the loop stops there."""
    t_max = enc.shape[1]
    u_max = min(u_max, t_max * max(max_sym_exp - 1, 1) + 1)
    K, blank, dev = beam_size, model.cfg.blank_id, enc.device
    rows = _start(K, u_max, dev)
    for t in range(min(t_max, int(enc_lens[0]))):
        h_k = enc[0, t][None, :].expand(K, -1)
        a = _empty(K, u_max, dev)
        c = rows
        for v in range(max_sym_exp):
            logp = _round(model, h_k, c)
            a = _merge_rows(a, (c[0], c[1], c[2] + logp[:, blank]))
            if v < max_sym_exp - 1:
                c = _expand_topk(c, logp, blank, u_max)
        rows = a
    return _collect(rows, nbest, score_norm)


def _prefix_augment(model, rows: Rows, h_t: torch.Tensor, prefix_alpha: int) -> torch.Tensor:
    """prefix_search: for each live pair where row i is a proper prefix of
    row j, at most ``prefix_alpha`` labels shorter, row j absorbs score_i +
    the log-probs of emitting j's extra labels at this frame."""
    tokens, n, score = rows
    K, u = tokens.shape
    out_all = model.decode_labels(tokens)  # [K, U+1, H]
    logits = model.joint_step(h_t[None, :].expand(K * (u + 1), -1),
                              out_all.reshape(K * (u + 1), -1))
    logp = F.log_softmax(logits.float(), dim=-1).reshape(K, u + 1, -1)
    emit_lp = torch.gather(logp[:, :u, :], 2, tokens[:, :, None])[..., 0]  # [K, U]
    cum = torch.cat([emit_lp.new_zeros(K, 1), torch.cumsum(emit_lp, dim=1)], dim=1)  # [K, U+1]
    pos = torch.arange(u, device=tokens.device)
    common = torch.where(pos[None, None, :] < torch.minimum(n[:, None], n[None, :])[:, :, None],
                         tokens[:, None, :] == tokens[None, :, :], True).all(dim=-1)
    live = score > NEG_INF / 2
    pair = (common & (n[:, None] < n[None, :]) & ((n[None, :] - n[:, None]) <= prefix_alpha)
            & live[:, None] & live[None, :])  # [i, j]: i a proper prefix of j
    cum_nj = cum.gather(1, n[:, None])[:, 0]  # cum[j, n_j]
    cum_j_ni = cum[None, :, :].expand(K, K, u + 1).gather(
        2, n[:, None, None].expand(K, K, 1))[..., 0]  # [i, j] = cum[j, n_i]
    contrib = torch.where(pair, score[:, None] + (cum_nj[None, :] - cum_j_ni), NEG_INF)
    new_score = torch.logsumexp(torch.cat([score[None, :], contrib], dim=0), dim=0)
    return torch.where(live, new_score, score)


def _subtract_mask(c: Rows, logp: torch.Tensor, blank: int, u_max: int) -> torch.Tensor:
    """subtract(): candidate (p, its w-th best token) duplicates row q iff
    n_q = n_p + 1, q[:n_p] = p[:n_p] and the token is q[n_p] -> [K, W]."""
    c_tok, c_n, _ = c
    K = c_n.shape[0]
    pos = torch.arange(u_max, device=c_tok.device)
    pref_eq = torch.where(pos[None, None, :] < c_n[:, None, None],
                          c_tok[:, None, :] == c_tok[None, :, :], True).all(dim=-1)
    one_longer = (c_n[None, :] == c_n[:, None] + 1) & pref_eq  # [p, q]
    q_next = c_tok[None, :, :].expand(K, K, u_max).gather(
        2, c_n.clamp(0, u_max - 1)[:, None, None].expand(K, K, 1))[..., 0]  # [p, q] = q[n_p]
    w = min(K, logp.shape[-1] - 1)
    _, top_id = _top_k(logp.index_fill(1, torch.tensor([blank], device=logp.device), NEG_INF), w)
    return (one_longer[:, None, :] & (top_id[:, :, None] == q_next[:, None, :])).any(dim=-1)


def transducer_nsc_decode(model, enc: torch.Tensor, enc_lens: torch.Tensor, beam_size: int = 5,
                          nstep: int = 2, prefix_alpha: int = 4, u_max: int = 200,
                          nbest: int = 1, score_norm: bool = True) -> List[Hypothesis]:
    """N-step constrained beam search of one utterance (enc [1, T, D]); the
    token table is min(u_max, T * max(nstep, 1) + 1) wide."""
    t_max = enc.shape[1]
    u_max = min(u_max, t_max * max(nstep, 1) + 1)
    K, blank, dev = beam_size, model.cfg.blank_id, enc.device
    rows = _start(K, u_max, dev)
    for t in range(min(t_max, int(enc_lens[0]))):
        h_t = enc[0, t]
        h_k = h_t[None, :].expand(K, -1)
        c = (rows[0], rows[1], _prefix_augment(model, rows, h_t, prefix_alpha))
        s_buf = _empty(K, u_max, dev)
        for v in range(nstep + 1):
            logp = _round(model, h_k, c)
            s_buf = _merge_rows(s_buf, (c[0], c[1], c[2] + logp[:, blank]))
            if v < nstep:
                c = _expand_topk(c, logp, blank, u_max,
                                 dup_mask=_subtract_mask(c, logp, blank, u_max))
        rows = s_buf
    return _collect(rows, nbest, score_norm)


def transducer_multiblank_greedy(model, enc: torch.Tensor, enc_lens: torch.Tensor,
                                 big_blank_ids: Sequence[int] = (),
                                 big_blank_durations: Sequence[int] = (), u_max: int = 200,
                                 max_symbols_per_frame: int = 3) -> List[Hypothesis]:
    """Multi-blank greedy decoding of one utterance (enc [1, T, D]): at most
    ``max_symbols_per_frame + 1`` argmax steps a frame; a blank or a big
    blank ends the frame, and big blank i skips the next
    ``big_blank_durations[i] - 1`` frames.  The score sums the chosen
    log-probs in float32.  One host read of the argmax a step decides what
    happens next, so skipped frames and finished frames cost nothing."""
    durations = {}
    for k, d in zip(big_blank_ids, big_blank_durations):
        durations.setdefault(int(k), int(d))  # the first of repeated ids, as in JAX
    blank = model.cfg.blank_id
    dev = enc.device
    tokens = torch.zeros((1, u_max), dtype=torch.long, device=dev)
    n, skip_until = 0, 0
    score = torch.zeros((), device=dev)
    for t in range(min(enc.shape[1], int(enc_lens[0]))):
        if t < skip_until:
            continue
        h_t = enc[0, t][None, :]
        for _ in range(max_symbols_per_frame + 1):
            g = model.decode_labels(tokens)[:, n]
            logp = F.log_softmax(model.joint_step(h_t, g)[0].float(), dim=-1)
            k = int(torch.argmax(logp))
            score = score + logp[k]
            if k == blank or k in durations:
                skip_until = t + durations.get(k, 1)
                break
            if n < u_max - 1:
                tokens[0, n] = k
                n += 1
    return [Hypothesis(yseq=tokens[0, :n].tolist(), score=float(score), scores={})]
