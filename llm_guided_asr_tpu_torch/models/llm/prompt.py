"""Prompt templates and packing for LLM-guided ASR (counterpart of llm_guided_asr_tpu/models/llm/prompt.py).

:func:`split_template` tokenizes a template and splits it at ``((HYP))``
(and an optional ``((BIAS))`` before it); the marker span is searched over
1..8 tokens, so any tokenizer works.  [prefix | (bias | mid |) hyp |
suffix | response] segments are scattered to per-row offsets with
validity masks, as static-shape tensor ops on the device.  Hypothesis
padding therefore sits mid-row; LlamaModel positions are cumsum(valid)-1,
which equals the reference's contiguous layout.

Mixed-vocab CTC: :func:`build_ctc_to_llm_map` precomputes, once on the
host, the LLM ids of each CTC token, and :func:`expand_token_ids` expands a
CTC-vocab hypothesis to LLM ids on the device (a gather and a scatter).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PromptTemplate:
    """Static token-id segments of the templated prompt.

    With a ``((BIAS))`` marker in the template (contextual biasing),
    ``mid_ids`` holds the static tokens between the bias words and the
    hypothesis, and each utterance's bias words are packed at the marker.
    """

    prefix_ids: Tuple[int, ...]  # [bos] + template before ((BIAS)) or ((HYP))
    suffix_ids: Tuple[int, ...]  # template after ((HYP))
    start_of_response_id: int  # sos of the guided decoder
    end_of_response_id: int
    pad_id: int
    mid_ids: Optional[Tuple[int, ...]] = None  # between ((BIAS)) and ((HYP))

    @property
    def has_bias_slot(self) -> bool:
        return self.mid_ids is not None

    @property
    def prefix_len(self) -> int:
        return len(self.prefix_ids)

    @property
    def suffix_len(self) -> int:
        return len(self.suffix_ids)


def _find_marker(tokens, marker: str, max_marker_tokens: int = 10):
    """(start, width) of the first token span that spells ``marker`` once
    word-boundary decorations are turned into spaces and stripped."""
    for i in range(len(tokens)):
        for w in range(1, max_marker_tokens + 1):
            joined = "".join(tokens[i : i + w])
            cleaned = joined.replace("\u2581", " ").replace("\u0120", " ").strip()
            if cleaned == marker:
                return i, w
    return None


def split_template(
    tokenizer,
    template_prompt: Optional[str],
    bos_token_id: int,
    eos_token_id: int,
    pad_token: Optional[str] = None,
    hyp_marker: str = "((HYP))",
    bias_marker: str = "((BIAS))",
    max_marker_tokens: int = 8,
) -> PromptTemplate:
    """Tokenize the template and split it at ``((HYP))`` (and ``((BIAS))``).

    No template: the prompt is bos alone and the response is delimited by
    bos and eos.  Otherwise the response delimiter is the double-quote
    token that wraps ``((HYP))``, or bos where the vocabulary has none.
    """
    if pad_token is not None:
        pad_id = tokenizer.convert_tokens_to_ids(pad_token)
    else:
        pad_id = tokenizer.pad_token_id if tokenizer.pad_token_id is not None else 0
    if pad_id is None:
        pad_id = 0
    if not template_prompt:
        return PromptTemplate(prefix_ids=(bos_token_id,), suffix_ids=(),
                              start_of_response_id=bos_token_id,
                              end_of_response_id=eos_token_id, pad_id=pad_id)
    tokens = tokenizer.tokenize(template_prompt)
    found = _find_marker(tokens, hyp_marker, max_marker_tokens)
    if found is None:
        raise ValueError(f"marker {hyp_marker!r} not found in template tokens: {tokens}")
    i, w = found
    before_hyp = tokens[:i]
    suffix = tokenizer.convert_tokens_to_ids(tokens[i + w :])
    mid = None
    bias_found = _find_marker(before_hyp, bias_marker, max_marker_tokens)
    if bias_found is not None:
        bi, bw = bias_found
        mid = tuple(tokenizer.convert_tokens_to_ids(before_hyp[bi + bw :]))
        before_hyp = before_hyp[:bi]
    prefix = [bos_token_id] + tokenizer.convert_tokens_to_ids(before_hyp)
    quote_id = tokenizer.convert_tokens_to_ids('"')
    if quote_id is None or quote_id == tokenizer.unk_token_id:
        quote_id = bos_token_id
    return PromptTemplate(prefix_ids=tuple(prefix), suffix_ids=tuple(suffix),
                          start_of_response_id=quote_id, end_of_response_id=quote_id,
                          pad_id=pad_id, mid_ids=mid)


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
    bias: Optional[torch.Tensor] = None,  # [B, W] per-utterance biasing ids
    bias_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack [prefix | (bias | mid |) hyp | suffix | resp]; returns
    (ids, valid, resp_start).  The bias segment is packed only where the
    template has a ``((BIAS))`` slot and bias ids are given."""
    if template.has_bias_slot and bias is not None:
        statics = [template.prefix_ids, template.mid_ids, template.suffix_ids, ()]
        parts = [(bias, bias_lengths), (hyp, hyp_lengths), (resp, resp_lengths)]
    else:
        statics = [template.prefix_ids, template.suffix_ids, ()]
        parts = [(hyp, hyp_lengths), (resp, resp_lengths)]
    ids, valid, starts = pack_segments(statics, parts, template.pad_id)
    return ids, valid, starts[:, -1]


def expand_token_ids(
    map_ids: torch.Tensor,  # [Vc, M] LLM ids of each CTC token
    map_lens: torch.Tensor,  # [Vc]
    hyp: torch.Tensor,  # [B, H] CTC-vocab ids (left-aligned)
    hyp_lengths: torch.Tensor,  # [B]
    pad_id: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A CTC-vocab hypothesis -> LLM-vocab ids [B, H*M] and lengths [B]:
    each token's expansion is scattered after the previous ones'.  Equal to
    retokenizing the detokenized string wherever the pieces retokenize
    independently (exact at word boundaries)."""
    b, hmax = hyp.shape
    m = map_ids.shape[1]
    dev = hyp.device
    out_w = hmax * m
    tok_valid = torch.arange(hmax, device=dev)[None, :] < hyp_lengths[:, None]
    safe = torch.clamp(hyp.long(), 0, map_ids.shape[0] - 1)
    exp = map_ids.long()[safe]  # [B, H, M]
    lens = torch.where(tok_valid, map_lens.long()[safe], torch.zeros_like(safe))  # [B, H]
    starts = torch.cumsum(lens, dim=1) - lens
    pos = starts[:, :, None] + torch.arange(m, device=dev)[None, None, :]  # [B, H, M]
    ok = torch.arange(m, device=dev)[None, None, :] < lens[:, :, None]
    # positions past the row (none, as sum(lens) <= H*M) and unused slots go
    # to a spare column that is cut off
    pos = torch.where(ok, pos, torch.full_like(pos, out_w))
    out = torch.full((b, out_w + 1), pad_id, dtype=torch.int64, device=dev)
    out.scatter_(1, pos.reshape(b, -1), torch.where(ok, exp, torch.full_like(exp, pad_id))
                 .reshape(b, -1))
    return out[:, :out_w], lens.sum(dim=1)


def build_ctc_to_llm_map(ctc_token_list, tokenizer, max_expand: int = 8):
    """The CTC-token -> LLM-ids table (host side, once): sentencepiece word
    markers become spaces; special tokens (``<blank>``, ``<unk>``,
    ``<sos/eos>`` ...) expand to nothing.  Returns int32 arrays ids
    [Vc, max_expand] and lens [Vc]."""
    vc = len(ctc_token_list)
    ids = np.zeros((vc, max_expand), np.int32)
    lens = np.zeros((vc,), np.int32)
    for i, tok in enumerate(ctc_token_list):
        if tok.startswith("<") and tok.endswith(">"):
            continue
        text = tok.replace("\u2581", " ").replace("\u0120", " ")
        e = tokenizer(text, add_special_tokens=False)["input_ids"][:max_expand]
        ids[i, : len(e)] = e
        lens[i] = len(e)
    return ids, lens


def gather_response(hidden: torch.Tensor, resp_start: torch.Tensor, l_max: int) -> torch.Tensor:
    """Response-position hidden states [B, total, D] -> [B, l_max, D]."""
    total = hidden.shape[1]
    idx = resp_start[:, None] + torch.arange(l_max, device=hidden.device)[None, :]
    idx = torch.clamp(idx, 0, total - 1)
    return torch.gather(hidden, 1, idx[..., None].expand(-1, -1, hidden.shape[2]))
