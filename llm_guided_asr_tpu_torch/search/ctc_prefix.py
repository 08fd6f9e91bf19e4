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
as a log-depth scan in the (logaddexp, +) semiring.  Every function takes a
leading lane axis (B utterances decoded in lockstep, each with its own
valid length); a lane's numbers do not depend on the others.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1.0e10


class CTCPrefixState(NamedTuple):
    """Per-beam DP state carried across decode steps, for B lanes
    (utterances) of K hypotheses each."""

    r: torch.Tensor  # [B, K, T, 2] (r_nb, r_b) of each hyp's prefix
    psi: torch.Tensor  # [B, K] prefix score of each hyp
    last: torch.Tensor  # [B, K] last token id of each hyp
    empty: torch.Tensor  # [B, K] bool: prefix is empty (sos only)


def _valid_frames(t_max: int, length: torch.Tensor) -> torch.Tensor:
    """[B, T] mask of each lane's valid frames (length [B])."""
    return torch.arange(t_max, device=length.device)[None, :] < length[:, None]


def ctc_prefix_init(logp: torch.Tensor, length: torch.Tensor, beam: int,
                    blank_id: int = 0) -> CTCPrefixState:
    """State of the empty prefix, replicated over the beam.

    logp: [B, T, V] CTC log-softmax of each lane; length [B]: valid frames.
    """
    b, t_max = logp.shape[:2]
    dev = logp.device
    valid = _valid_frames(t_max, length)
    xb = logp[..., blank_id]  # [B, T]
    r_b = torch.cumsum(torch.where(valid, xb, torch.zeros_like(xb)), dim=1)
    r_b = torch.where(valid, r_b, torch.full_like(r_b, NEG_INF))
    r_nb = torch.full_like(r_b, NEG_INF)
    r = torch.stack([r_nb, r_b], dim=-1)  # [B, T, 2]
    return CTCPrefixState(
        r=r[:, None].expand(b, beam, t_max, 2).clone(),
        psi=torch.zeros((b, beam), device=dev),
        last=torch.full((b, beam), -1, dtype=torch.int64, device=dev),
        empty=torch.ones((b, beam), dtype=torch.bool, device=dev),
    )


def _prefix_rows(state_r: torch.Tensor):
    """(r_b, logaddexp(r_nb, r_b)) of the parents [..., T]: phi is the first
    where c repeats last(g), the second otherwise."""
    r_nb, r_b = state_r[..., 0], state_r[..., 1]
    return r_b, torch.logaddexp(r_nb, r_b)


def _gather_frames(logp: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """logp [B, T, V] at each lane's tokens [B, N] -> [B, T, N]."""
    t_max = logp.shape[1]
    return torch.gather(logp, 2, tokens[:, None, :].expand(-1, t_max, -1))


def ctc_prefix_psi(
    logp: torch.Tensor,  # [B, T, V]
    length: torch.Tensor,  # [B] valid frames
    state: CTCPrefixState,  # B lanes of K
    cand: torch.Tensor,  # [B, K, W] candidate token ids
    blank_id: int = 0,
    eos_id: int = -1,
) -> torch.Tensor:
    """Prefix scores psi(g.c) [B, K, W] without the new DP rows.

    For c == eos the score is the complete-sequence probability of g; blank
    is never a label, so its score is log-zero.
    """
    b, t_max = logp.shape[:2]
    k, w = cand.shape[1:]
    valid = _valid_frames(t_max, length)  # [B, T]
    x = _gather_frames(logp, cand.reshape(b, k * w)).reshape(b, t_max, k, w)
    x = x.permute(0, 2, 1, 3)  # [B, K, T, W]
    x = x.masked_fill(~valid[:, None, :, None], NEG_INF)
    r_b, r_sum = _prefix_rows(state.r)  # [B, K, T]
    same = (cand == state.last[..., None])[:, :, None, :]  # [B, K, 1, W]
    phi = torch.where(same, r_b[..., None], r_sum[..., None])  # [B, K, T, W]
    psi_0 = torch.where(state.empty[..., None], x[:, :, 0, :],
                        torch.full_like(x[:, :, 0, :], NEG_INF))
    contrib = phi[:, :, :-1, :] + x[:, :, 1:, :]  # [B, K, T-1, W]
    psi = torch.logaddexp(psi_0, torch.logsumexp(contrib, dim=2))
    t_last = torch.clamp(length - 1, 0, t_max - 1)  # [B]
    final_sum = torch.gather(r_sum, 2, t_last[:, None, None].expand(b, k, 1))  # [B, K, 1]
    if eos_id >= 0:
        psi = torch.where(cand == eos_id, final_sum.expand_as(psi), psi)
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
    logp: torch.Tensor,  # [B, T, V]
    length: torch.Tensor,  # [B] valid frames
    state: CTCPrefixState,  # B lanes of K (pre-selection)
    token: torch.Tensor,  # [B, K'] selected token per new slot
    parent: torch.Tensor,  # [B, K'] parent hyp index in 0..K-1
    psi_new: torch.Tensor,  # [B, K'] psi of the selected extensions
    blank_id: int = 0,
) -> CTCPrefixState:
    """Run the DP recurrence for the K' selected extensions of each lane only."""
    b, t_max = logp.shape[:2]
    kp = token.shape[1]
    dev = logp.device
    valid = _valid_frames(t_max, length)  # [B, T]
    r_prev = torch.gather(state.r, 1, parent[:, :, None, None].expand(b, kp, t_max, 2))
    last = torch.gather(state.last, 1, parent)
    empty = torch.gather(state.empty, 1, parent)

    x = _gather_frames(logp, token).transpose(1, 2)  # [B, K', T]
    x = x.masked_fill(~valid[:, None, :], NEG_INF)
    xb = logp[..., blank_id].masked_fill(~valid, NEG_INF)  # [B, T]
    r_b_prev, r_sum_prev = _prefix_rows(r_prev)
    phi = torch.where((token == last)[..., None], r_b_prev, r_sum_prev)  # [B, K', T]

    r_nb_0 = torch.where(empty, x[..., 0], torch.full_like(x[..., 0], NEG_INF))  # [B, K']
    r_b_0 = torch.full((b, kp), NEG_INF, device=dev)

    # the scans run over frames, dim 0: [T-1, B, K']
    ca, cb = _scan(x[..., 1:].permute(2, 0, 1), (phi[..., :-1] + x[..., 1:]).permute(2, 0, 1))
    r_nb = torch.cat([r_nb_0[None], torch.logaddexp(r_nb_0[None] + ca, cb)], dim=0)  # [T, B, K']

    xb_t = xb[:, 1:].t()[:, :, None].expand(t_max - 1, b, kp)
    ca, cb = _scan(xb_t, r_nb[:-1] + xb_t)
    r_b = torch.cat([r_b_0[None], torch.logaddexp(r_b_0[None] + ca, cb)], dim=0)

    return CTCPrefixState(
        r=torch.stack([r_nb.permute(1, 2, 0), r_b.permute(1, 2, 0)], dim=-1),  # [B, K', T, 2]
        psi=psi_new,
        last=token.long(),
        empty=torch.zeros((b, kp), dtype=torch.bool, device=dev),
    )


def ctc_prefix_extend(
    state: CTCPrefixState,  # B lanes of K, rows computed over old_len frames
    logp: torch.Tensor,  # [B, T, V] CTC log-softmax (rows >= new_len unused)
    old_len: torch.Tensor,  # [B] frames the state was computed over
    new_len: torch.Tensor,  # [B] frames available now
    blank_id: int = 0,
) -> CTCPrefixState:
    """Streaming extension of the alive hypotheses' DP rows over the new
    frames [old_len, new_len) (CTCPrefixScoreTH.extend_state,
    ctc_prefix_score.py:244-270): only the blank row goes on, r_b[t] =
    r_b[t-1] + x[t, blank]; r_nb is log-zero there (paths that emit the
    prefix's last label inside the new frames are not carried; the JAX
    package makes the same approximation).  psi, last and empty stay.

    The running sum is a cumulative sum over the row with zeros off the
    new frames, as in the JAX function; the two cumsums associate their
    additions differently, so the rows agree to float32 rounding.
    """
    t_max = logp.shape[1]
    tpos = torch.arange(t_max, device=logp.device)[None, :]
    ext = (tpos >= old_len[:, None]) & (tpos < new_len[:, None])  # [B, T]
    xb = torch.where(ext, logp[..., blank_id], torch.zeros_like(logp[..., blank_id]))
    cum = torch.cumsum(xb, dim=1)  # [B, T]
    b, k = state.psi.shape
    base_idx = torch.clamp(old_len - 1, 0, t_max - 1)
    base = torch.gather(state.r[..., 1], 2, base_idx[:, None, None].expand(b, k, 1))[..., 0]
    # nothing processed yet: the blank row starts from log(1) = 0, not r_b[0]
    base = torch.where((old_len > 0)[:, None], base, torch.zeros_like(base))  # [B, K]
    ext = ext[:, None, :]
    r_nb = state.r[..., 0].masked_fill(ext, NEG_INF)
    r_b = torch.where(ext, base[..., None] + cum[:, None, :], state.r[..., 1])
    return state._replace(r=torch.stack([r_nb, r_b], dim=-1))
