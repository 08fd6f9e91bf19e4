"""Transformer attention decoder (counterpart of llm_guided_asr_tpu/models/transformer_decoder.py).

Token embedding * sqrt(d) + sinusoidal positions, N pre-norm decoder
layers with causal self-attention and cross-attention over the encoder
output, a final LayerNorm and the vocabulary projection (with
``tie_input_output``, the embedding table transposed, no bias).  The
LLM-guided model builds its guided decoder's blocks from the same
config.

:class:`ConvTransformerDecoder` is the ``lightconv``/``dynamicconv``
decoder (the JAX module's ``_CausalConvAttn`` :118 and
``ConvTransformerDecoder`` :162): its blocks put a causal lightweight or
dynamic convolution where the self-attention was.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    DecoderLayer,
    LayerNorm,
    MultiHeadedAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    add_and_norm,
    sigmoid,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import causal_attn_mask, make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


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
    """(memory [B, T, D], lengths, ys_in [B, L], lengths) -> logits [B, L, V],
    computed in the memory's type (the model's compute dtype): the
    embedding rows are cast to it, as flax's ``nn.Embed`` with ``dtype``
    casts its table."""

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
            self.output_layer = Dense(d_model, vocab_size)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor, ys_in: torch.Tensor,
                ys_in_lengths: torch.Tensor, rng: Optional[StepRNG] = None,
                only_last: bool = False) -> torch.Tensor:
        """``only_last`` keeps the hidden state at position len-1 of each row
        before the output layer: [B, V] logits for the beam search's scorer,
        which needs no other position."""
        cfg = self.cfg
        x = self.pos_enc(self.embed(ys_in).to(memory.dtype), rng=rng)
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
        if cfg.tie_input_output:  # flax embed.attend, in x's type
            return x @ self.embed.weight.to(x.dtype).t()
        return self.output_layer(x)


class CausalConvAttn(nn.Module):
    """The causal lightweight or dynamic convolution sublayer: ``in_proj``
    to 2D and GLU (v = a * sigmoid(g)), then over the window of the
    ``kernel_size`` positions ending at each position (zeros before the
    first) a per-head weighted sum, then ``out_proj``.  The light weights
    are the softmax over the taps of ``conv_weight`` [heads, K], shared by
    every position; the dynamic ones the per-head softmax of
    ``weight_proj(v)`` (of the GLU output, as in JAX)."""

    def __init__(self, d: int, heads: int, kernel_size: int, dynamic: bool):
        super().__init__()
        self.heads, self.kernel_size, self.dynamic = heads, kernel_size, dynamic
        self.in_proj = Dense(d, 2 * d)
        if dynamic:
            self.weight_proj = Dense(d, heads * kernel_size)
        else:
            self.conv_weight = nn.Parameter(torch.zeros(heads, kernel_size))
        self.out_proj = Dense(d, d)

    def forward(self, x):
        b, length, d = x.shape
        k, h = self.kernel_size, self.heads
        a, g = self.in_proj(x).chunk(2, dim=-1)
        v = a * sigmoid(g)
        # [B, L, D, K] windows; tap K-1 is the position itself
        win = F.pad(v, (0, 0, k - 1, 0)).unfold(1, k, 1).reshape(b, length, h, d // h, k)
        if self.dynamic:
            w = torch.softmax(self.weight_proj(v).reshape(b, length, h, k), dim=-1)
            out = torch.einsum("blhgk,blhk->blhg", win, w)
        else:
            w = torch.softmax(self.conv_weight.float(), dim=-1).to(v.dtype)
            out = torch.einsum("blhgk,hk->blhg", win, w)
        return self.out_proj(out.reshape(b, length, d))


class ConvTransformerDecoder(nn.Module):
    """The ``lightconv`` (``dynamic=False``) and ``dynamicconv`` decoders:
    embedding * sqrt(d) + sinusoidal positions, pads zeroed, then per block
    pre-norm residual branches ``block_{i}_conv`` (CausalConvAttn),
    ``block_{i}_src_attn`` (dense MHA over the memory) and ``block_{i}_ff``,
    then ``after_norm`` and ``output_layer``.  No ``tie_input_output``.
    Computed in the memory's type, as :class:`TransformerDecoder`."""

    def __init__(self, vocab_size: int, cfg: TransformerDecoderConfig, d_model: int,
                 dynamic: bool = False, kernel_size: int = 11,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.tie_input_output:
            raise ValueError("the lightconv/dynamicconv decoders have no tie_input_output")
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.embed = nn.Embedding(vocab_size, d_model)
            self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
            for i in range(cfg.num_blocks):
                for name, module in (
                        ("norm1", LayerNorm(d_model)),
                        ("conv", CausalConvAttn(d_model, cfg.attention_heads, kernel_size,
                                                dynamic)),
                        ("norm2", LayerNorm(d_model)),
                        ("src_attn", MultiHeadedAttention(d_model, cfg.attention_heads,
                                                          cfg.src_attention_dropout_rate)),
                        ("norm3", LayerNorm(d_model)),
                        ("ff", PositionwiseFeedForward(d_model, cfg.linear_units,
                                                       dropout_rate=cfg.dropout_rate))):
                    setattr(self, f"block_{i}_{name}", module)
            if cfg.normalize_before:
                self.after_norm = LayerNorm(d_model)
            if cfg.use_output_layer:
                self.output_layer = Dense(d_model, vocab_size)

    def forward(self, memory: torch.Tensor, memory_lengths: torch.Tensor, ys_in: torch.Tensor,
                ys_in_lengths: torch.Tensor, rng: Optional[StepRNG] = None,
                only_last: bool = False) -> torch.Tensor:
        cfg = self.cfg
        rate = active_rate(self, cfg.dropout_rate)
        x = self.pos_enc(self.embed(ys_in).to(memory.dtype), rng=rng)
        x = x.masked_fill(~make_valid_mask(ys_in_lengths, ys_in.shape[1])[..., None], 0.0)
        memory_mask = make_valid_mask(memory_lengths, memory.shape[1])[:, None, :]
        for i in range(cfg.num_blocks):
            block = lambda name: getattr(self, f"block_{i}_{name}")  # noqa: E731
            x, h = add_and_norm(x, dropout(block("conv")(block("norm1")(x)), rate, rng),
                                block("norm2"))
            h = block("src_attn")(h, memory, memory, memory_mask, rng=rng)
            x, h = add_and_norm(x, dropout(h, rate, rng), block("norm3"))
            x = x + dropout(block("ff")(h, rng), rate, rng)
        if cfg.normalize_before:
            x = self.after_norm(x)
        if only_last:
            x = x[torch.arange(x.shape[0], device=x.device), ys_in_lengths - 1]
        return self.output_layer(x) if cfg.use_output_layer else x
