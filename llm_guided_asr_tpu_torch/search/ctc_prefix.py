"""CTC prefix scoring (counterpart of llm_guided_asr_tpu/search/ctc_prefix.py).

Given a hypothesis prefix g and candidate tokens c, psi(g.c) is the CTC
prefix log-probability (Watanabe et al. hybrid CTC/attention):

  r_nb[t](h): paths of t frames collapsing to h, last frame emits last(h)
  r_b[t](h):  paths of t frames collapsing to h, last frame blank
  phi[t] = logaddexp(r_b[t](g), r_nb[t](g))   (just r_b if c == last(g))
  r_nb[t](g.c) = logaddexp(r_nb[t-1](g.c), phi[t-1]) + x[t, c]
  r_b[t](g.c)  = logaddexp(r_b[t-1](g.c), r_nb[t-1](g.c)) + x[t, blank]
  psi(g.c) = r_nb[0](g.c) (+) logsumexp_t(phi[t-1] + x[t, c])

psi is a reduction over the parent's rows; the T-long recurrences run only
for the K extensions that survive a beam step (:func:`ctc_prefix_advance`),
as a log-depth scan in the (logaddexp, +) semiring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1.0e10


class CTCPrefixState(NamedTuple):
    """Per-beam DP state carried across decode steps."""

    r: torch.Tensor  # [K, T, 2] (r_nb, r_b) of each hyp's prefix
    psi: torch.Tensor  # [K] prefix score of each hyp
    last: torch.Tensor  # [K] last token id of each hyp
    empty: torch.Tensor  # [K] bool: prefix is empty (sos only)


def ctc_prefix_init(logp: torch.Tensor, length, beam: int, blank_id: int = 0) -> CTCPrefixState:
    """State of the empty prefix, replicated over the beam.

    logp: [T, V] CTC log-softmax of one utterance; length: valid frames.
    """
    t_max = logp.shape[0]
    dev = logp.device
    valid = torch.arange(t_max, device=dev) < length
    xb = logp[:, blank_id]
    r_b = torch.cumsum(torch.where(valid, xb, torch.zeros_like(xb)), dim=0)
    r_b = torch.where(valid, r_b, torch.full_like(r_b, NEG_INF))
    r_nb = torch.full_like(r_b, NEG_INF)
    r = torch.stack([r_nb, r_b], dim=-1)  # [T, 2]
    return CTCPrefixState(
        r=r[None].expand(beam, t_max, 2).clone(),
        psi=torch.zeros(beam, device=dev),
        last=torch.full((beam,), -1, dtype=torch.int64, device=dev),
        empty=torch.ones(beam, dtype=torch.bool, device=dev),
    )


def _prefix_rows(state_r: torch.Tensor):
    """(r_b, logaddexp(r_nb, r_b)) of the parents [K, T]: phi is the first
    where c repeats last(g), the second otherwise."""
    r_nb, r_b = state_r[..., 0], state_r[..., 1]
    return r_b, torch.logaddexp(r_nb, r_b)


def ctc_prefix_psi(
    logp: torch.Tensor,  # [T, V]
    length,  # valid frames (scalar)
    state: CTCPrefixState,  # beam K
    cand: torch.Tensor,  # [K, W] candidate token ids
    blank_id: int = 0,
    eos_id: int = -1,
) -> torch.Tensor:
    """Prefix scores psi(g.c) [K, W] without the new DP rows.

    For c == eos the score is the complete-sequence probability of g; blank
    is never a label, so its score is log-zero.
    """
    t_max = logp.shape[0]
    valid = torch.arange(t_max, device=logp.device) < length  # [T]
    x = logp[:, cand].permute(1, 0, 2)  # [K, T, W]
    x = x.masked_fill(~valid[None, :, None], NEG_INF)
    r_b, r_sum = _prefix_rows(state.r)
    same = (cand == state.last[:, None])[:, None, :]  # [K, 1, W]
    phi = torch.where(same, r_b[:, :, None], r_sum[:, :, None])  # [K, T, W]
    psi_0 = torch.where(state.empty[:, None], x[:, 0, :], torch.full_like(x[:, 0, :], NEG_INF))
    contrib = phi[:, :-1, :] + x[:, 1:, :]  # [K, T-1, W]
    psi = torch.logaddexp(psi_0, torch.logsumexp(contrib, dim=1))
    t_last = torch.clamp(torch.as_tensor(length, device=logp.device) - 1, 0, t_max - 1)
    final_sum = r_sum[:, t_last]  # [K]
    if eos_id >= 0:
        psi = torch.where(cand == eos_id, final_sum[:, None].expand_as(psi), psi)
    return psi.masked_fill(cand == blank_id, NEG_INF)


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over dim 0 of f_t(r) = logaddexp(r + a[t], b[t]).

    compose(f1, f2) = (a1 + a2, logaddexp(b1 + a2, b2)) is associative;
    Hillis-Steele doubling applies it in ceil(log2 T) whole-tensor steps
    (a closed form with cumsum/logcumsumexp cancels catastrophically in
    float32 once masked frames carry -1e10).
    """
    n = a.shape[0]
    s = 1
    while s < n:
        a_new = a.clone()
        b_new = b.clone()
        a_new[s:] = a[:-s] + a[s:]
        b_new[s:] = torch.logaddexp(b[:-s] + a[s:], b[s:])
        a, b = a_new, b_new
        s *= 2
    return a, b


def ctc_prefix_advance(
    logp: torch.Tensor,  # [T, V]
    length,  # valid frames (scalar)
    state: CTCPrefixState,  # beam K (pre-selection)
    token: torch.Tensor,  # [K'] selected token per new slot
    parent: torch.Tensor,  # [K'] parent hyp index in 0..K-1
    psi_new: torch.Tensor,  # [K'] psi of the selected extensions
    blank_id: int = 0,
) -> CTCPrefixState:
    """Run the DP recurrence for the K' selected extensions only."""
    t_max = logp.shape[0]
    kp = token.shape[0]
    dev = logp.device
    valid = torch.arange(t_max, device=dev) < length  # [T]
    r_prev = state.r[parent]  # [K', T, 2]
    last = state.last[parent]
    empty = state.empty[parent]

    x = logp[:, token].t().masked_fill(~valid[None, :], NEG_INF)  # [K', T]
    xb = logp[:, blank_id].masked_fill(~valid, NEG_INF)  # [T]
    r_b_prev, r_sum_prev = _prefix_rows(r_prev)
    phi = torch.where((token == last)[:, None], r_b_prev, r_sum_prev)  # [K', T]

    r_nb_0 = torch.where(empty, x[:, 0], torch.full_like(x[:, 0], NEG_INF))  # [K']
    r_b_0 = torch.full((kp,), NEG_INF, device=dev)

    ca, cb = _scan(x[:, 1:].t(), (phi[:, :-1] + x[:, 1:]).t())  # [T-1, K']
    r_nb = torch.cat([r_nb_0[None], torch.logaddexp(r_nb_0[None] + ca, cb)], dim=0)  # [T, K']

    xb_t = xb[1:, None].expand(t_max - 1, kp)
    ca, cb = _scan(xb_t, r_nb[:-1] + xb_t)
    r_b = torch.cat([r_b_0[None], torch.logaddexp(r_b_0[None] + ca, cb)], dim=0)

    return CTCPrefixState(
        r=torch.stack([r_nb.t(), r_b.t()], dim=-1),  # [K', T, 2]
        psi=psi_new,
        last=token.long(),
        empty=torch.zeros(kp, dtype=torch.bool, device=dev),
    )
