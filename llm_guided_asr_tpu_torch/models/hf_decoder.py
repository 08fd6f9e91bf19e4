"""Pretrained causal LM as the ASR attention decoder (counterpart of
llm_guided_asr_tpu/models/hf_decoder.py; ``decoder: hugging_face``).

The encoder output goes through ``linear_in`` into the LM's embedding
space and is spliced into the input as continuous "audio token"
embeddings:

    [prefix ids] [projected encoder frames] [postfix ids] [ys tokens]

(hugging_face_transformers_decoder.py add_prefix_postfix).  The LM is the
port's :class:`LlamaModel` (Llama/Qwen2, read from a local directory by
models/llm/llama.py); the audio span is at most ``enc_frames_max`` frames,
its pads sit mid-row and are masked out of the attention, positions skip
them (the model's cumsum positions).  The logits at the ys positions are
the decoder's output, float32; ``only_last`` keeps each row's last one
(the stateless beam scorer's call).  The parameters are float32, as the
task builds them; the decoder computes in the model's compute dtype
(``dtype``: float32, or bfloat16 as JAX's ``LlamaModel(dtype=...)`` over
float32 parameters), the LM's norms and softmaxes in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel
from llm_guided_asr_tpu_torch.models.transformer import Dense
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.rng import StepRNG


@dataclasses.dataclass(frozen=True)
class HFCausalDecoderConfig:
    llm: LlamaConfig
    prefix_ids: Tuple[int, ...] = ()  # the tokenized text prompt before the audio
    postfix_ids: Tuple[int, ...] = ()  # the tokenized text prompt after the audio
    enc_frames_max: int = 512  # the audio span's width (longer encoder output is cut)


class HFCausalDecoder(nn.Module):
    def __init__(self, cfg: HFCausalDecoderConfig, d_in: int,
                 device: Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        # float32 computes in the parameters' own type (which follows .double())
        self.llm = LlamaModel(cfg.llm, dtype=torch.float32, device=dev, lm_head=True,
                              compute_dtype=None if dtype == torch.float32 else dtype)
        with torch.device(dev):
            self.linear_in = Dense(d_in, cfg.llm.hidden_size)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor, ys_in: torch.Tensor,
                ys_in_lengths: torch.Tensor, rng: Optional[StepRNG] = None,
                only_last: bool = False) -> torch.Tensor:
        """memory [B, T, D], ys_in [B, L] -> logits [B, L, V] (or [B, V])."""
        cfg = self.cfg
        b, l = ys_in.shape
        dev = ys_in.device
        p, q = len(cfg.prefix_ids), len(cfg.postfix_ids)
        t_enc = min(memory.shape[1], cfg.enc_frames_max)
        total = p + t_enc + q + l
        enc = self.linear_in(memory[:, :t_enc])
        enc_valid = (torch.arange(t_enc, device=dev)[None, :]
                     < torch.clamp(memory_lengths, max=t_enc)[:, None])
        ids = torch.zeros((b, total), dtype=torch.long, device=dev)
        if p:
            ids[:, :p] = torch.tensor(cfg.prefix_ids, device=dev)
        if q:
            ids[:, p + t_enc: p + t_enc + q] = torch.tensor(cfg.postfix_ids, device=dev)
        ids[:, p + t_enc + q:] = torch.clamp(ys_in, min=0)
        pos = torch.arange(total, device=dev)[None, :]
        in_enc = (pos >= p) & (pos < p + t_enc)
        enc_valid_full = torch.zeros((b, total), dtype=torch.bool, device=dev)
        enc_valid_full[:, p: p + t_enc] = enc_valid
        ys_valid = (pos - (p + t_enc + q)) < ys_in_lengths[:, None]
        valid = ((pos < p) | (in_enc & enc_valid_full)
                 | ((pos >= p + t_enc) & (pos < p + t_enc + q))
                 | ((pos >= p + t_enc + q) & ys_valid))
        override = torch.zeros((b, total, cfg.llm.hidden_size), dtype=enc.dtype, device=dev)
        override[:, p: p + t_enc] = enc.masked_fill(~enc_valid[..., None], 0.0)
        _, logits, _ = self.llm(ids, valid, return_logits=True, embed_override=override,
                                override_mask=in_enc & valid)
        ys_logits = logits[:, p + t_enc + q:].float()
        if only_last:
            return ys_logits[torch.arange(b, device=dev), ys_in_lengths - 1]
        return ys_logits
