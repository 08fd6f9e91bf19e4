"""Masked batch norm, training mode (counterpart of llm_guided_asr_tpu/ops/masked_bn.py).

Per-feature statistics over the VALID (batch, time) positions of [B, T, C]
activations; every position, pads included, is normalised with them.
The backward is the closed form of the JAX package's custom VJP:

  x_hat = (x - mu) * rsqrt(var + eps)
  dgamma = sum_all(dy * x_hat)          dbeta = sum_all(dy)
  dx     = gamma * inv * (dy - m * (dbeta/n + x_hat * dgamma/n))   m: valid mask

(the reductions run over all positions because every position's output
reads the statistics; the mask gates which inputs feel the gradient
through them).  The variance is the biased one, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch


class _MaskedBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, valid, scale, bias, eps):
        m = valid[..., None].float()
        n = m.sum().clamp_min(1.0)
        xf = x.float()
        xm = xf * m
        mean = xm.sum(dim=(0, 1)) / n
        var = ((xm * xf).sum(dim=(0, 1)) / n - mean * mean).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        y = (xf - mean) * (inv * scale) + bias
        ctx.save_for_backward(x, valid, scale, mean, inv, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy_out, _dmean, _dvar):
        x, valid, scale, mean, inv, n = ctx.saved_tensors
        m = valid[..., None].float()
        dy = dy_out.float()
        x_hat = (x.float() - mean) * inv
        dbeta = dy.sum(dim=(0, 1))
        dgamma = (dy * x_hat).sum(dim=(0, 1))
        dx = (scale * inv) * (dy - m * (dbeta / n + x_hat * (dgamma / n)))
        return dx.to(dy_out.dtype), None, dgamma, dbeta, None


def masked_batch_norm(x: torch.Tensor, valid: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode masked BN over x [B, T, C] with valid [B, T] bool.
    Returns (y, mean, var); mean and var feed the running-statistics update
    only and carry no gradient."""
    return _MaskedBatchNormFn.apply(x, valid, scale, bias, eps)
