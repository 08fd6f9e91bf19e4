"""SpecAugment (counterpart of llm_guided_asr_tpu/ops/specaug.py).

Time warp (linear resampling, as in JAX; the reference's default is
bicubic), frequency masks and time masks over [B, T, F] log-mel features.
Each augmentation is split into the sampling of its random values (from
an explicit ``torch.Generator`` on the features' device) and their
application, a pure function of those values, so that a test can feed the
same values to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugConfig:
    apply_time_warp: bool = True
    time_warp_window: int = 5
    apply_freq_mask: bool = True
    freq_mask_width_range: Tuple[int, int] = (0, 20)
    num_freq_mask: int = 2
    apply_time_mask: bool = True
    time_mask_width_range: Optional[Tuple[int, int]] = None
    time_mask_width_ratio_range: Optional[Tuple[float, float]] = None
    num_time_mask: int = 2


def _uniform(gen: torch.Generator, shape, device, lo: float = 0.0, hi: float = 1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def sample_time_warp(gen: torch.Generator, lengths: torch.Tensor,
                     window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(center, shift) [B]: center uniform in [window, max(len-window,
    window+1)), shift uniform in [-window, window)."""
    b = lengths.shape[0]
    lens = lengths.float()
    lo = float(window)
    hi = torch.clamp(lens - window, min=lo + 1.0)
    center = lo + _uniform(gen, (b,), lengths.device) * (hi - lo)
    shift = _uniform(gen, (b,), lengths.device, -float(window), float(window))
    return center, shift


def time_warp(feats: torch.Tensor, lengths: torch.Tensor, center: torch.Tensor,
              shift: torch.Tensor) -> torch.Tensor:
    """Move frame ``center`` to ``center + shift`` (clipped to [1, len-1])
    and re-sample both sides linearly; frames past each length are kept."""
    _, t, _ = feats.shape
    lens = lengths.float()
    warped = torch.minimum(torch.clamp(center + shift, min=1.0), lens - 1.0)
    pos = torch.arange(t, dtype=torch.float32, device=feats.device)[None, :]
    c, w, ln = center[:, None], warped[:, None], lens[:, None]
    # piecewise-linear inverse map: out [0,w) <- in [0,c); out [w,len) <- in [c,len)
    src = torch.where(
        pos < w,
        pos * c / torch.clamp(w, min=1e-6),
        c + (pos - w) * (ln - c) / torch.clamp(ln - w, min=1e-6),
    )
    src = torch.clamp(src, 0.0, t - 1.0)
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=t - 1)
    frac = (src - i0.float())[..., None]
    idx = lambda i: i[..., None].expand(-1, -1, feats.shape[2])  # noqa: E731
    out = torch.gather(feats, 1, idx(i0)) * (1.0 - frac) + torch.gather(feats, 1, idx(i1)) * frac
    return torch.where((pos < ln)[..., None], out, feats)


def sample_mask_starts(gen: torch.Generator, widths: torch.Tensor, axis_len: int) -> torch.Tensor:
    """Mask starts [B, M] uniform in [0, axis_len - width]."""
    u = torch.rand(widths.shape, generator=gen, device=widths.device)
    return (u * (axis_len - widths + 1).float()).to(torch.int64)


def mask_along_axis(feats: torch.Tensor, starts: torch.Tensor, widths: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """Zero the spans [start, start + width) of every mask [B, M] along
    ``axis`` (1 = time, 2 = frequency)."""
    pos = torch.arange(feats.shape[axis], device=feats.device)
    inside = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    masked = inside.any(dim=1)  # [B, L]
    masked = masked[:, :, None] if axis == 1 else masked[:, None, :]
    return feats.masked_fill(masked, 0.0)


def _randint(gen, lo: int, hi: int, shape, device) -> torch.Tensor:
    return torch.randint(lo, hi + 1, shape, generator=gen, device=device)


def specaug(gen: torch.Generator, feats: torch.Tensor, lengths: torch.Tensor,
            cfg: SpecAugConfig) -> torch.Tensor:
    """[B, T, F] log-mel -> augmented log-mel (same shape)."""
    b, t, f = feats.shape
    dev = feats.device
    if cfg.apply_time_warp:
        center, shift = sample_time_warp(gen, lengths, cfg.time_warp_window)
        feats = time_warp(feats, lengths, center, shift)
    if cfg.apply_freq_mask:
        w0, w1 = cfg.freq_mask_width_range
        widths = torch.clamp(_randint(gen, w0, w1, (b, cfg.num_freq_mask), dev), max=f)
        feats = mask_along_axis(feats, sample_mask_starts(gen, widths, f), widths, axis=2)
    if cfg.apply_time_mask:
        if cfg.time_mask_width_ratio_range is not None:
            r0, r1 = cfg.time_mask_width_ratio_range
            ratios = _uniform(gen, (b, cfg.num_time_mask), dev, r0, r1)
            widths = (ratios * lengths[:, None].float()).to(torch.int64)
        else:
            w0, w1 = cfg.time_mask_width_range or (0, 40)
            widths = _randint(gen, w0, w1, (b, cfg.num_time_mask), dev)
        widths = torch.clamp(widths, max=t)
        feats = mask_along_axis(feats, sample_mask_starts(gen, widths, t), widths, axis=1)
    return feats
