"""Length masks (counterpart of llm_guided_asr_tpu/utils/masks.py).

All masks follow the *valid* convention: True = keep / attend.
"""

from __future__ import annotations

import torch


def make_valid_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B] lengths -> [B, maxlen] bool, True where position < length."""
    pos = torch.arange(maxlen, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def causal_attn_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B] -> [B, maxlen, maxlen] combined causal + padding attention mask."""
    valid = make_valid_mask(lengths, maxlen)
    causal = torch.ones(maxlen, maxlen, dtype=torch.bool, device=lengths.device).tril()
    return valid[:, None, :] & causal[None, :, :]


def mask_fill(x: torch.Tensor, valid: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Fill positions where ``valid`` is False; ``valid`` broadcasts over x."""
    while valid.dim() < x.dim():
        valid = valid[..., None]
    return x.masked_fill(~valid, fill_value)
