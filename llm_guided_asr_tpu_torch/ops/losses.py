"""Loss functions: CTC, label-smoothing KL, accuracy (counterpart of llm_guided_asr_tpu/ops/losses.py).

CTC is ``torch.nn.functional.ctc_loss`` on float32 log-probabilities (the
JAX package's forward-backward CTC, ops/ctc_fb.py, is plain XLA and no
TPU kernel); an infeasible example counts 0 and takes no gradient.  The
Bayes-risk CTC (``time_risk`` != 0, ``ctc_type: brctc``) runs the same
lattice over emissions tilted by a delay risk, with JAX's gradient
(:class:`BayesRiskCTC`).  The
label-smoothing loss is the KL divergence of torch's KLDivLoss, entropy
term included, over the batch size or the token count.  All reductions
run in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask


def ctc_loss_per_example(logits: torch.Tensor, logit_lengths: torch.Tensor,
                         labels: torch.Tensor, label_lengths: torch.Tensor,
                         blank_id: int = 0, time_risk: float = 0.0) -> torch.Tensor:
    """Per-example CTC negative log-likelihood [B] from [B, T, V]
    pre-softmax logits; non-finite examples (infeasible alignments) are 0
    and take no gradient.  ``time_risk`` != 0: the Bayes-risk CTC."""
    label_valid = make_valid_mask(label_lengths, labels.shape[1])
    labels = torch.where(label_valid, labels, 0).long()
    if time_risk != 0.0:
        return BayesRiskCTC.apply(logits, logit_lengths.long(), labels, label_lengths.long(),
                                  blank_id, float(time_risk))
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    per_ex = F.ctc_loss(logp.transpose(0, 1), labels, logit_lengths.long(), label_lengths.long(),
                        blank=blank_id, reduction="none", zero_infinity=True)
    return torch.where(torch.isfinite(per_ex), per_ex, 0.0)


class BayesRiskCTC(torch.autograd.Function):
    """Bayes-risk CTC (ops/ctc_fb.py ``_fb`` with ``time_risk``): every
    token state at frame t is charged ``time_risk * t / max(len, 1)``, and
    the loss is the CTC lattice's -log P over those tilted emissions.  The
    tilt is the same for every non-blank entry of a frame, so it is the
    builtin lattice over log-probs whose non-blank entries are lowered by
    it (a label equal to the blank would go untilted here, where JAX tilts
    it).

    The gradient to the logits is JAX's custom VJP: softmax minus the
    tilted posterior, zero on frames past the length and for infeasible
    examples.  Autograd through F.ctc_loss on the tilted log-probs would
    be wrong: its backward returns exp(input) - posterior, which is the
    gradient only when each row of the input sums to one in probability.
    So the posterior is recovered from that backward (exp(input) minus
    it), and the forward computes the gradient once and saves it.  The
    softmax is scaled by the posterior's mass at each frame, 1 in exact
    arithmetic, as the builtin CTC's autograd through log_softmax scales
    it: that keeps the float32 rounding of -log P, common to a frame's
    posteriors, out of the gradient."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank_id: int,
                time_risk: float):
        lp = F.log_softmax(logits.detach().float(), dim=-1)  # [B, T, V]
        b, t_max, v = lp.shape
        frames = torch.arange(t_max, device=lp.device, dtype=torch.float32)
        risk = time_risk * frames[None, :] / torch.clamp(logit_lengths.float(), min=1.0)[:, None]
        token = torch.ones(v, dtype=torch.bool, device=lp.device)
        token[blank_id] = False
        tilted = (lp - risk[..., None] * token).requires_grad_(True)
        with torch.enable_grad():
            nll = F.ctc_loss(tilted.transpose(0, 1), labels, logit_lengths, label_lengths,
                             blank=blank_id, reduction="none", zero_infinity=False)
            g_in, = torch.autograd.grad(nll.sum(), tilted)
        feasible = torch.isfinite(nll)
        posterior = tilted.detach().exp() - g_in
        grad = lp.exp() * posterior.sum(dim=-1, keepdim=True) - posterior
        t_valid = torch.arange(t_max, device=lp.device)[None, :] < logit_lengths[:, None]
        keep = (t_valid & feasible[:, None])[..., None]
        ctx.save_for_backward(torch.where(keep, grad, 0.0))
        ctx.logits_dtype = logits.dtype
        return torch.where(feasible, nll.detach(), 0.0)

    @staticmethod
    def backward(ctx, g_out):
        grad, = ctx.saved_tensors
        return (grad * g_out[:, None, None]).to(ctx.logits_dtype), None, None, None, None, None


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0,
             time_risk: float = 0.0) -> torch.Tensor:
    """Batch-mean CTC loss: the sum over the batch divided by B (the
    reference's 'builtin' reduction)."""
    per_ex = ctc_loss_per_example(logits, logit_lengths, labels, label_lengths,
                                  blank_id=blank_id, time_risk=time_risk)
    return per_ex.sum() / logits.shape[0]


def label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor, smoothing: float = 0.0,
                         ignore_id: int = -1, normalize_length: bool = False) -> torch.Tensor:
    """KL(smoothed one-hot || softmax(logits)) over [B, L, V], summed over
    the valid targets and divided by B, or by their count when
    ``normalize_length``."""
    b, _, v = logits.shape
    valid = targets != ignore_id
    tgt = torch.where(valid, targets, 0).long()
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    confidence = 1.0 - smoothing
    low = smoothing / (v - 1)
    tgt_logp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    sum_logp = logp.sum(dim=-1)
    cross = -(confidence * tgt_logp + low * (sum_logp - tgt_logp))
    # the constant entropy term of the smoothed target, as torch's KLDivLoss has it
    ent = confidence * math.log(max(confidence, 1e-20)) + (v - 1) * low * math.log(max(low, 1e-20))
    kl = torch.where(valid, cross + ent, 0.0)
    denom = valid.sum().float() if normalize_length else torch.tensor(float(b), device=logits.device)
    return kl.sum() / torch.clamp(denom, min=1.0)


def accuracy(logits: torch.Tensor, targets: torch.Tensor, ignore_id: int = -1) -> torch.Tensor:
    """Token accuracy over the targets that are not ``ignore_id``."""
    pred = logits.argmax(dim=-1)
    valid = targets != ignore_id
    correct = ((pred == targets) & valid).sum()
    return correct.float() / torch.clamp(valid.sum(), min=1).float()


def add_sos_eos(text: torch.Tensor, text_lengths: torch.Tensor, sos: int, eos: int,
                ignore_id: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys_in [B, L+1] = [sos, y..., 0-pad], ys_out [B, L+1] = [y..., eos,
    ignore-pad]); the decoder masks ys_in by text_lengths + 1."""
    b, l = text.shape
    valid = make_valid_mask(text_lengths, l)
    clean = torch.where(valid, text, 0)
    ys_in = torch.cat([torch.full((b, 1), sos, dtype=text.dtype, device=text.device), clean], 1)
    pos = torch.arange(l + 1, device=text.device)[None, :]
    ys_out = torch.cat([clean, torch.zeros((b, 1), dtype=text.dtype, device=text.device)], 1)
    ys_out = torch.where(pos == text_lengths[:, None], eos, ys_out)
    ys_out = torch.where(pos > text_lengths[:, None], ignore_id, ys_out)
    return ys_in, ys_out
