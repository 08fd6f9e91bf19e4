"""Transformer building blocks (counterpart of llm_guided_asr_tpu/models/transformer.py).

Module and parameter names follow the flax modules (``linear_q``,
``pos_bias_u``, ``norm1`` ...) so that convert.params_from_jax maps one tree
onto the other by path.  Masks follow the valid convention (True = attend).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.ops.rel_attention import rel_attention

NEG_INF = -1.0e9  # large-negative attention bias of the dense paths


def LayerNorm(d: int, eps: float = 1e-5) -> nn.LayerNorm:
    """LayerNorm with torch's epsilon 1e-5, as the JAX helper sets it."""
    return nn.LayerNorm(d, eps=eps)


@functools.lru_cache(maxsize=8)
def rel_pos_enc(length: int, d_model: int) -> np.ndarray:
    """Transformer-XL table for relative positions [length-1 .. -(length-1)]:
    row i encodes position (length-1-i), shape [2*length-1, d_model]
    (espnet RelPositionalEncoding, 'latest')."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * length - 1, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div_term)
    pe[:, 1::2] = np.cos(pos * div_term)
    return pe.astype(np.float32)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, hidden_units: int,
                 activation: Callable = torch.relu):
        super().__init__()
        self.w_1 = nn.Linear(d_model, hidden_units)
        self.w_2 = nn.Linear(hidden_units, d_model)
        self.activation = activation

    def forward(self, x):
        return self.w_2(self.activation(self.w_1(x)))


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax in float32 with a valid-mask; fully masked rows become zero
    (attention.py forward_attention)."""
    if mask.dim() == 3:
        mask = mask[:, None]  # [B, 1, Tq, Tk]
    scores = scores.masked_fill(~mask, NEG_INF)
    attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
    return attn.masked_fill(~mask, 0.0)


class MultiHeadedAttention(nn.Module):
    """Standard MHA (attention.py MultiHeadedAttention)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.h, self.d_k = num_heads, d_model // num_heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)

    def _proj(self, x, layer):
        y = layer(x)
        return y.reshape(*y.shape[:-1], self.h, self.d_k)

    def project_kv(self, key, value) -> Tuple[torch.Tensor, torch.Tensor]:
        """k/v projections [B, Tk, H, dk] (utterance-constant cross-attention cache)."""
        return self._proj(key, self.linear_k), self._proj(value, self.linear_v)

    def forward(self, query, key, value, mask, kv_precomputed=None):
        q = self._proj(query, self.linear_q)
        if kv_precomputed is not None:
            k, v = kv_precomputed
        else:
            k, v = self.project_kv(key, value)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        attn = masked_softmax(scores, mask)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.linear_out(out.reshape(*out.shape[:-2], self.h * self.d_k))


class RelPositionMultiHeadedAttention(nn.Module):
    """Transformer-XL relative-position MHA (attention.py RelPositionMultiHeadedAttention).

    score = ((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_k), with a
    key-padding mask.  The attention core is ops/rel_attention.py: the CUDA
    kernel for tensors on the card, the dense rel-shift path on the CPU.
    """

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.h, self.d_k = num_heads, d_model // num_heads
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.linear_out = nn.Linear(d_model, d_model)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.d_k))

    def forward(self, x, pos_emb, valid):
        """x [B, T, D]; pos_emb [1, 2T-1, D]; valid [B, T] key mask."""
        b, t, d = x.shape

        def heads(y):  # [..., T, D] -> [B, H, T, dk]
            return y.reshape(y.shape[0], y.shape[1], self.h, self.d_k).transpose(1, 2)

        q = self.linear_q(x).reshape(b, t, self.h, self.d_k)
        qu = (q + self.pos_bias_u).transpose(1, 2).contiguous()
        qv = (q + self.pos_bias_v).transpose(1, 2).contiguous()
        k = heads(self.linear_k(x)).contiguous()
        v = heads(self.linear_v(x)).contiguous()
        p = heads(self.linear_pos(pos_emb))[0].contiguous()  # [H, 2T-1, dk]
        out = rel_attention(qu, qv, k, v, p, valid.to(torch.int32).contiguous(),
                            1.0 / math.sqrt(self.d_k))
        return self.linear_out(out.transpose(1, 2).reshape(b, t, d))


class RelPositionalEncoding(nn.Module):
    """Scale the input by sqrt(d) and emit the [1, 2T-1, D] relative table."""

    def forward(self, x):
        t, d = x.shape[1], x.shape[2]
        pos = torch.from_numpy(rel_pos_enc(t, d)).to(device=x.device, dtype=x.dtype)
        return x * math.sqrt(d), pos[None]


class Conv2dSubsampling(nn.Module):
    """x4 time subsampling by two stride-2 3x3 convs (subsampling.py Conv2dSubsampling).

    The JAX module convolves NHWC and flattens (F', C) with C minor; the
    NCHW output here is permuted to [B, T', F', C] before the same flatten,
    so the ``out`` weights carry over unchanged.
    """

    def __init__(self, idim: int, odim: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(1, odim, 3, stride=2)
        self.conv_1 = nn.Conv2d(odim, odim, 3, stride=2)
        f2 = ((idim - 1) // 2 - 1) // 2
        self.out = nn.Linear(odim * f2, odim)

    def forward(self, x):
        h = torch.relu(self.conv_0(x[:, None]))
        h = torch.relu(self.conv_1(h))
        h = h.permute(0, 2, 3, 1)  # [B, T', F', C]
        return self.out(h.reshape(h.shape[0], h.shape[1], -1))


def sub4_frames(t: int) -> int:
    return ((t - 1) // 2 - 1) // 2


def sub4_lengths(lengths: torch.Tensor, t: Optional[int] = None) -> torch.Tensor:
    """Lengths after Conv2dSubsampling: the reference's mask arithmetic
    rounds up, (L+3)//4, clamped to the conv output width for ``t`` frames."""
    out = torch.div(lengths + 3, 4, rounding_mode="floor")
    if t is not None:
        out = torch.clamp(out, max=sub4_frames(t))
    return out


class DecoderLayer(nn.Module):
    """Pre-norm transformer decoder layer (decoder_layer.py): self-attn, src-attn, FFN."""

    def __init__(self, d_model: int, num_heads: int, linear_units: int):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.self_attn = MultiHeadedAttention(d_model, num_heads)
        self.norm2 = LayerNorm(d_model)
        self.src_attn = MultiHeadedAttention(d_model, num_heads)
        self.norm3 = LayerNorm(d_model)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units)

    def project_mem_kv(self, memory):
        """src_attn's (k, v) of the memory, computed once per utterance."""
        return self.src_attn.project_kv(memory, memory)

    def forward(self, tgt, tgt_mask, memory, memory_mask, self_kv=None, mem_kv=None):
        """tgt [B, Lq, D]; self_kv: optional [B, Lk, D] full key/value input
        stream (incremental decode); mem_kv: precomputed memory (k, v)."""
        h = self.norm1(tgt)
        hk = self.norm1(self_kv) if self_kv is not None else h
        x = tgt + self.self_attn(h, hk, hk, tgt_mask)
        h = self.norm2(x)
        x = x + self.src_attn(h, memory, memory, memory_mask, kv_precomputed=mem_kv)
        return x + self.feed_forward(self.norm3(x))
