"""RNN-Transducer loss as an anti-diagonal wavefront (counterpart of llm_guided_asr_tpu/ops/rnnt.py).

The [T, U+1] lattice recursion

  alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                          alpha[t, u-1] + emit[t, u-1])

runs one anti-diagonal (t + u = d) per step, T + U + 1 steps, each one
vectorized op over (batch, u), in the JAX package's association.  The
multi-blank loss runs the same wavefront with big-blank transitions read
from a ring of the last max(durations) diagonals.  The gradient comes
from autograd: in the JAX package this is plain XLA, not a TPU kernel, so
it stays plain PyTorch here.  Unreachable cells hold NEG_INF = -1e30
(finite, as in JAX).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def rnnt_alpha(logp_blank: torch.Tensor, logp_emit: torch.Tensor, t_lengths: torch.Tensor,
               u_lengths: torch.Tensor, logp_bigs: Sequence[torch.Tensor] = (),
               durations: Sequence[int] = ()) -> torch.Tensor:
    """Total log-likelihood [B] = alpha[T-1, U] + blank[T-1, U], from
    logp_blank and logp_emit [B, T, U+1] (emit[t, u] = log P(y_{u+1} | t,
    u)); with big blanks (``logp_bigs`` [B, T, U+1] each, of
    ``durations`` frames), alpha[t, u] also takes alpha[t - d, u] +
    big[t - d, u], and the total also the final big-blank transitions of
    every duration that fits."""
    b, t_max, u1 = logp_blank.shape
    dev = logp_blank.device
    n_diag = t_max + u1
    u_idx = torch.arange(u1, device=dev)
    t_idx = torch.arange(n_diag, device=dev)[:, None] - u_idx[None, :]  # [n_diag, U+1]
    on = (t_idx >= 0) & (t_idx < t_max)
    blank_ok = on & (t_idx >= 1)
    emit_ok = on & (u_idx >= 1)
    origin = (t_idx == 0) & (u_idx == 0)
    # every diagonal's transition weights, gathered once: [B, n_diag, U+1]
    u_all = u_idx.expand_as(t_idx)
    blank_w = logp_blank[:, (t_idx - 1).clamp(0, t_max - 1), u_all]
    emit_w = logp_emit[:, t_idx.clamp(0, t_max - 1), (u_idx - 1).clamp(min=0).expand_as(t_idx)]
    big_w = [big[:, (t_idx - d).clamp(0, t_max - 1), u_all] for big, d in zip(logp_bigs, durations)]
    big_ok = [on & (t_idx >= d) for d in durations]
    neg = torch.full((b, 1), NEG_INF, dtype=logp_blank.dtype, device=dev)
    # hist[j] = diagonal d-1-j
    hist = [torch.full((b, u1), NEG_INF, dtype=logp_blank.dtype, device=dev)] * max([1, *durations])
    diags = []
    for d in range(n_diag):
        prev = hist[0]
        val = torch.logaddexp(torch.where(blank_ok[d], prev + blank_w[:, d], NEG_INF),
                              torch.where(emit_ok[d], torch.cat([neg, prev[:, :-1]], dim=1)
                                          + emit_w[:, d], NEG_INF))
        for w, ok, dur in zip(big_w, big_ok, durations):
            val = torch.logaddexp(val, torch.where(ok[d], hist[dur - 1] + w[:, d], NEG_INF))
        val = torch.where(origin[d], 0.0, val)
        alpha = torch.where(on[d], val, NEG_INF)
        hist = [alpha] + hist[:-1]
        diags.append(alpha)
    diags = torch.stack(diags)  # [n_diag, B, U+1]; cell (t, u) at [t + u, :, u]
    bi = torch.arange(b, device=dev)
    ll = (diags[t_lengths - 1 + u_lengths, bi, u_lengths]
          + logp_blank[bi, (t_lengths - 1).clamp(0, t_max - 1), u_lengths])
    for big, dur in zip(logp_bigs, durations):
        cand = (diags[(t_lengths - dur + u_lengths).clamp(0, n_diag - 1), bi, u_lengths]
                + big[bi, (t_lengths - dur).clamp(0, t_max - 1), u_lengths])
        ll = torch.logaddexp(ll, torch.where(t_lengths >= dur, cand, NEG_INF))
    return ll


def _emit(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logp [B, T, U+1, V] at each position's next label -> [B, T, U+1],
    the column past the last label NEG_INF."""
    b, u_max = labels.shape
    safe = labels.long().clamp(0, logp.shape[-1] - 1)
    idx = safe[:, None, :, None].expand(b, logp.shape[1], u_max, 1)
    emit = torch.gather(logp[:, :, :u_max, :], -1, idx)[..., 0]  # [B, T, U]
    return F.pad(emit, (0, 1), value=NEG_INF)


def rnnt_loss(logits: torch.Tensor, labels: torch.Tensor, t_lengths: torch.Tensor,
              u_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Mean negative log-likelihood over the batch, from the joint network's
    logits [B, T, U+1, V] and labels [B, U] (anything beyond the lengths)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = rnnt_alpha(logp[..., blank_id], _emit(logp, labels), t_lengths.long(),
                    u_lengths.long())
    return -ll.mean()


def rnnt_loss_multi_blank(logits: torch.Tensor, labels: torch.Tensor, t_lengths: torch.Tensor,
                          u_lengths: torch.Tensor, blank_id: int = 0,
                          big_blank_ids: Sequence[int] = (),
                          big_blank_durations: Sequence[int] = (),
                          sigma: float = 0.0) -> torch.Tensor:
    """Multi-blank transducer loss (Xu et al. 2023, arXiv:2211.03541): the
    mean negative log-likelihood of ``rnnt_loss`` with big blank i (id
    ``big_blank_ids[i]``) advancing ``big_blank_durations[i]`` frames, the
    final transitions through the standard blank and every big blank whose
    duration fits the utterance, and every transition weight lowered by
    ``sigma`` (logit under-normalization)."""
    if len(big_blank_ids) != len(big_blank_durations):
        raise ValueError("big_blank_ids and big_blank_durations differ in length")
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = rnnt_alpha(logp[..., blank_id] - sigma, _emit(logp, labels) - sigma, t_lengths.long(),
                    u_lengths.long(), [logp[..., i] - sigma for i in big_blank_ids],
                    [int(d) for d in big_blank_durations])
    return -ll.mean()
