"""Multichannel frontend math: WPE dereverberation and mask-based MVDR
(counterpart of llm_guided_asr_tpu/ops/beamformer.py).

- :func:`wpe_dereverb`: iterative weighted prediction-error
  dereverberation (Nara-WPE), batched over (batch, frequency): per
  frequency a multichannel linear prediction from ``taps`` delayed frames,
  solved as a power-weighted least-squares system of C·taps unknowns.
- :func:`mvdr_beamform`: Souden MVDR from time-frequency masks,
  w = (Phi_n^-1 Phi_s / tr(Phi_n^-1 Phi_s)) e_ref.

Both take complex64 (or complex128) on any device and return the input's
dtype, but compute their statistics and solves in complex128 (the JAX
package in complex64).  The tap-stacked channels of an array are strongly
correlated, so WPE's C·taps system is ill-conditioned: in complex64 its
output sits ~1e-3 of its largest value off the exact one on six
CHiME-4-like channels, and MVDR's mask-weighted sums over ~1,250 frames
round differently on the card and the CPU (tools/mc_stage_rounding.py).
The systems are small (C·taps and C square), so the work is batched
matrix products and ``torch.linalg.solve``; there is no hand-written
kernel here (the JAX package computes these outside any Pallas kernel
too).  Autograd runs through every step, so the masks train through the
beamformer.
"""

from __future__ import annotations

import torch


def _stack_taps(y: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """y [..., C, T] -> the delayed tap stack [..., C*taps, T]: tap k holds
    y[t - delay - k] (zeros before the signal's start)."""
    t = y.shape[-1]
    outs = []
    for k in range(taps):
        shift = min(delay + k, t)
        pad = y.new_zeros(y.shape[:-1] + (shift,))
        outs.append(torch.cat([pad, y[..., : t - shift]], dim=-1))
    return torch.cat(outs, dim=-2)


def _weighted_gram(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_t a[..., i, t] w[..., t] conj(b[..., j, t]) -> [..., I, J]."""
    return (a * w[..., None, :]) @ b.conj().transpose(-1, -2)


def wpe_dereverb(y: torch.Tensor, taps: int = 5, delay: int = 3, iterations: int = 3,
                 eps: float = 1e-6) -> torch.Tensor:
    """complex [B, F, C, T] -> the dereverberated signal [B, F, C, T], in
    y's dtype (computed in complex128)."""
    y64 = y.to(torch.complex128)
    ytil = _stack_taps(y64, taps, delay)  # [B, F, C*taps, T]
    eye = torch.eye(ytil.shape[-2], dtype=y64.dtype, device=y.device)
    x = y64
    for _ in range(iterations):
        # the current estimate's power, averaged over channels
        inv_power = (1.0 / ((x.abs() ** 2).mean(dim=-2) + eps)).to(y64.dtype)  # [B, F, T]
        r = _weighted_gram(ytil, inv_power, ytil)  # [B, F, CT, CT]
        p = _weighted_gram(ytil, inv_power, y64)  # [B, F, CT, C]
        g = torch.linalg.solve(r + eps * eye, p)  # [B, F, CT, C]
        x = y64 - g.conj().transpose(-1, -2) @ ytil
    return x.to(y.dtype)


def psd_matrix(y: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mask-weighted cross-power spectral density of y [B, F, C, T] under
    mask [B, F, T] -> [B, F, C, C]."""
    num = _weighted_gram(y, mask.to(y.dtype), y)
    den = mask.sum(dim=-1)[:, :, None, None] + eps
    return num / den.to(y.dtype)


def mvdr_beamform(y: torch.Tensor, mask_speech: torch.Tensor, mask_noise: torch.Tensor,
                  ref_channel: int = 0, eps: float = 1e-6) -> torch.Tensor:
    """Souden MVDR: complex [B, F, C, T] and masks [B, F, T] -> the
    enhanced single-channel STFT [B, F, T] in y's dtype (computed in
    complex128)."""
    y64 = y.to(torch.complex128)
    phi_s = psd_matrix(y64, mask_speech.double(), eps)
    phi_n = psd_matrix(y64, mask_noise.double(), eps)
    eye = torch.eye(y.shape[-2], dtype=y64.dtype, device=y.device)
    num = torch.linalg.solve(phi_n + eps * eye, phi_s)  # [B, F, C, C]
    trace = num.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None]  # [B, F, 1]
    w = num[..., ref_channel] / (trace + eps)  # [B, F, C]
    return (w.conj()[..., None, :] @ y64)[..., 0, :].to(y.dtype)
