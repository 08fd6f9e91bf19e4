"""Prompt packing for LLM-guided ASR (counterpart of llm_guided_asr_tpu/models/llm/prompt.py).

[prefix | hyp | suffix | response] segments are scattered to per-row
offsets with validity masks, as static-shape tensor ops on the device.
Hypothesis padding therefore sits mid-row; LlamaModel positions are
cumsum(valid)-1, which equals the reference's contiguous layout.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PromptTemplate:
    """Static token-id segments of the templated prompt."""

    prefix_ids: Tuple[int, ...]  # [bos] + template before ((HYP))
    suffix_ids: Tuple[int, ...]  # template after ((HYP))
    start_of_response_id: int  # sos of the guided decoder
    end_of_response_id: int
    pad_id: int

    @property
    def prefix_len(self) -> int:
        return len(self.prefix_ids)

    @property
    def suffix_len(self) -> int:
        return len(self.suffix_ids)


def pack_segments(
    statics: Sequence[Tuple[int, ...]],  # n+1 static id tuples
    variables: Sequence[Tuple[torch.Tensor, torch.Tensor]],  # n of ([B, L], [B])
    pad_id: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter interleaved [s0 | v0 | s1 | v1 | ... | sn] rows.

    Returns (ids [B, total], valid [B, total], var_starts [B, n]) where
    var_starts[:, i] is the per-row offset of variable segment i.
    """
    if len(statics) != len(variables) + 1:
        raise ValueError("pack_segments needs one more static segment than variables")
    dev = variables[0][0].device
    b = variables[0][0].shape[0]
    total = sum(len(s) for s in statics) + sum(v.shape[1] for v, _ in variables)
    pos = torch.arange(total, device=dev)[None, :]
    ids = torch.full((b, total), pad_id, dtype=torch.int64, device=dev)
    valid = torch.zeros((b, total), dtype=torch.bool, device=dev)
    offset = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    var_starts = []
    for i, static in enumerate(statics):
        if len(static):
            arr = torch.tensor(static, dtype=torch.int64, device=dev)
            seg = arr[torch.clamp(pos - offset, 0, len(static) - 1)]
            inside = (pos >= offset) & (pos < offset + len(static))
            ids = torch.where(inside, seg, ids)
            valid = valid | inside
            offset = offset + len(static)
        if i < len(variables):
            v, vlen = variables[i]
            var_starts.append(offset[:, 0])
            if v.shape[1] > 0:
                idx = torch.clamp(pos - offset, 0, v.shape[1] - 1).expand(b, total)
                seg = torch.gather(v.long(), 1, idx)
                inside = (pos >= offset) & (pos < offset + vlen[:, None])
                ids = torch.where(inside, seg, ids)
                valid = valid | inside
            offset = offset + vlen[:, None].long()
    starts = torch.stack(var_starts, dim=1)
    return ids, valid, starts


def pack_prompt(
    template: PromptTemplate,
    hyp: torch.Tensor,  # [B, H] first-pass hyp ids (left-aligned)
    hyp_lengths: torch.Tensor,  # [B]
    resp: torch.Tensor,  # [B, L] response-so-far ids
    resp_lengths: torch.Tensor,  # [B]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack [prefix | hyp | suffix | resp]; returns (ids, valid, resp_start)."""
    statics = [template.prefix_ids, template.suffix_ids, ()]
    ids, valid, starts = pack_segments(
        statics, [(hyp, hyp_lengths), (resp, resp_lengths)], template.pad_id
    )
    return ids, valid, starts[:, -1]


def gather_response(hidden: torch.Tensor, resp_start: torch.Tensor, l_max: int) -> torch.Tensor:
    """Response-position hidden states [B, total, D] -> [B, l_max, D]."""
    total = hidden.shape[1]
    idx = resp_start[:, None] + torch.arange(l_max, device=hidden.device)[None, :]
    idx = torch.clamp(idx, 0, total - 1)
    return torch.gather(hidden, 1, idx[..., None].expand(-1, -1, hidden.shape[2]))
