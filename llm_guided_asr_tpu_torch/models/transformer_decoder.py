"""Transformer attention decoder (counterpart of llm_guided_asr_tpu/models/transformer_decoder.py).

Token embedding * sqrt(d) + sinusoidal positions, N pre-norm decoder
layers with causal self-attention and cross-attention over the encoder
output, a final LayerNorm and the vocabulary projection (with
``tie_input_output``, the embedding table transposed, no bias).  The
LLM-guided model builds its guided decoder's blocks from the same
config.  Not ported: the lightconv/dynamicconv variants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.transformer import (
    DecoderLayer,
    LayerNorm,
    PositionalEncoding,
)
from llm_guided_asr_tpu_torch.utils.masks import causal_attn_mask, make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG


@dataclasses.dataclass(frozen=True)
class TransformerDecoderConfig:
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    self_attention_dropout_rate: float = 0.0
    src_attention_dropout_rate: float = 0.0
    normalize_before: bool = True
    use_output_layer: bool = True
    tie_input_output: bool = False


def decoder_layers(cfg: TransformerDecoderConfig, d_model: int,
                   memory_dim: Optional[int] = None) -> list:
    """The config's ``num_blocks`` pre-norm decoder layers over a memory
    ``memory_dim`` wide (default ``d_model``)."""
    return [DecoderLayer(d_model, cfg.attention_heads, cfg.linear_units, cfg.dropout_rate,
                         cfg.self_attention_dropout_rate, cfg.src_attention_dropout_rate,
                         memory_dim) for _ in range(cfg.num_blocks)]


class TransformerDecoder(nn.Module):
    """(memory [B, T, D], lengths, ys_in [B, L], lengths) -> logits [B, L, V]."""

    def __init__(self, vocab_size: int, cfg: TransformerDecoderConfig, d_model: int):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
        for i, layer in enumerate(decoder_layers(cfg, d_model)):
            setattr(self, f"block_{i}", layer)
        if cfg.normalize_before:
            self.after_norm = LayerNorm(d_model)
        if cfg.use_output_layer and not cfg.tie_input_output:
            self.output_layer = nn.Linear(d_model, vocab_size)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor, ys_in: torch.Tensor,
                ys_in_lengths: torch.Tensor, rng: Optional[StepRNG] = None,
                only_last: bool = False) -> torch.Tensor:
        """``only_last`` keeps the hidden state at position len-1 of each row
        before the output layer: [B, V] logits for the beam search's scorer,
        which needs no other position."""
        cfg = self.cfg
        x = self.pos_enc(self.embed(ys_in), rng=rng)
        tgt_mask = causal_attn_mask(ys_in_lengths, ys_in.shape[1])
        memory_mask = make_valid_mask(memory_lengths, memory.shape[1])[:, None, :]
        for i in range(cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, tgt_mask, memory, memory_mask, rng=rng)
        if cfg.normalize_before:
            x = self.after_norm(x)
        if only_last:
            x = x[torch.arange(x.shape[0], device=x.device), ys_in_lengths - 1]
        if not cfg.use_output_layer:
            return x
        if cfg.tie_input_output:  # flax embed.attend
            return x @ self.embed.weight.t()
        return self.output_layer(x)
