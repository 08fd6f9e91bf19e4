"""RNN-Transducer loss as an anti-diagonal wavefront (counterpart of llm_guided_asr_tpu/ops/rnnt.py).

The [T, U+1] lattice recursion

  alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                          alpha[t, u-1] + emit[t, u-1])

runs one anti-diagonal (t + u = d) per step, T + U + 1 steps, each one
vectorized op over (batch, u), in the JAX package's association.  The
gradient comes from autograd: in the JAX package this is plain XLA, not a
TPU kernel, so it stays plain PyTorch here.  Unreachable cells hold
NEG_INF = -1e30 (finite, as in JAX).  ``rnnt_loss_multi_blank`` is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def rnnt_alpha(logp_blank: torch.Tensor, logp_emit: torch.Tensor, t_lengths: torch.Tensor,
               u_lengths: torch.Tensor) -> torch.Tensor:
    """Total log-likelihood [B] = alpha[T-1, U] + blank[T-1, U], from
    logp_blank and logp_emit [B, T, U+1] (emit[t, u] = log P(y_{u+1} | t, u))."""
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
    tb = (t_idx - 1).clamp(0, t_max - 1)
    tc = t_idx.clamp(0, t_max - 1)
    ue = (u_idx - 1).clamp(min=0).expand_as(tc)
    blank_w = logp_blank[:, tb, u_idx.expand_as(tb)]
    emit_w = logp_emit[:, tc, ue]
    neg = torch.full((b, 1), NEG_INF, dtype=logp_blank.dtype, device=dev)
    alpha = torch.full((b, u1), NEG_INF, dtype=logp_blank.dtype, device=dev)
    diags = []
    for d in range(n_diag):
        blank_in = alpha + blank_w[:, d]
        emit_in = torch.cat([neg, alpha[:, :-1]], dim=1) + emit_w[:, d]
        val = torch.logaddexp(torch.where(blank_ok[d], blank_in, NEG_INF),
                              torch.where(emit_ok[d], emit_in, NEG_INF))
        val = torch.where(origin[d], 0.0, val)
        alpha = torch.where(on[d], val, NEG_INF)
        diags.append(alpha)
    diags = torch.stack(diags)  # [n_diag, B, U+1]; cell (t, u) at [t + u, :, u]
    bi = torch.arange(b, device=dev)
    alpha_final = diags[t_lengths - 1 + u_lengths, bi, u_lengths]
    final_blank = logp_blank[bi, (t_lengths - 1).clamp(0, t_max - 1), u_lengths]
    return alpha_final + final_blank


def rnnt_loss(logits: torch.Tensor, labels: torch.Tensor, t_lengths: torch.Tensor,
              u_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Mean negative log-likelihood over the batch, from the joint network's
    logits [B, T, U+1, V] and labels [B, U] (anything beyond the lengths)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    logp_blank = logp[..., blank_id]  # [B, T, U+1]
    b, u_max = labels.shape
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    idx = safe[:, None, :, None].expand(b, logits.shape[1], u_max, 1)
    emit = torch.gather(logp[:, :, :u_max, :], -1, idx)[..., 0]  # [B, T, U]
    emit = F.pad(emit, (0, 1), value=NEG_INF)
    ll = rnnt_alpha(logp_blank, emit, t_lengths.long(), u_lengths.long())
    return -ll.mean()
