"""Greedy CTC decoding on the device (counterpart of llm_guided_asr_tpu/search/greedy.py)."""

from __future__ import annotations

from typing import Tuple

import torch

from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask


def ctc_greedy_decode(
    logits: torch.Tensor,  # [B, T, V] (pre- or post-softmax; argmax invariant)
    lengths: torch.Tensor,  # [B]
    blank_id: int = 0,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax -> collapse repeats -> drop blanks -> left-compact.

    Returns (tokens [B, T] left-aligned, padded with ``pad_id``; n_tokens [B]).
    """
    y = torch.argmax(logits, dim=-1)  # [B, T]
    b, t = y.shape
    valid = make_valid_mask(lengths, t)
    y = torch.where(valid, y, torch.full_like(y, blank_id))
    prev = torch.cat([torch.full_like(y[:, :1], -1), y[:, :-1]], dim=1)
    keep = (y != blank_id) & (y != prev) & valid
    pos = torch.cumsum(keep.long(), dim=1) - 1
    n_tokens = keep.long().sum(dim=1)
    # dropped tokens go to a spare column that is cut off afterwards
    pos = torch.where(keep, pos, torch.full_like(pos, t))
    out = torch.full((b, t + 1), pad_id, dtype=y.dtype, device=y.device)
    out.scatter_(1, pos, y)
    return out[:, :t], n_tokens
