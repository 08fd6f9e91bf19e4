"""Transformer building blocks (counterpart of llm_guided_asr_tpu/models/transformer.py).

Module and parameter names follow the flax modules (``linear_q``,
``pos_bias_u``, ``norm1`` ...) so that convert.params_from_jax maps one tree
onto the other by path.  Masks follow the valid convention (True = attend).
Dropout runs in training mode (``nn.Module.train()`` stands for the JAX
``deterministic=False``) and draws from the ``rng`` (utils/rng.py StepRNG)
that every forward takes.

Compute dtype (flax's ``dtype`` field): parameters stay float32 and every
module computes in its input's type, casting its parameters to it where
flax's ``promote_dtype`` casts them (:class:`Dense`, the rel-pos biases,
the subsampling convs), so a bfloat16 input runs the block in bfloat16 and
autograd returns float32 gradients for the float32 parameters.  LayerNorm
statistics and the attention softmaxes run in float32 (at least) and are
cast back, as flax's LayerNorm and the JAX modules do; a chain of
elementwise ops that XLA fuses (the attention scores' scale, the positional
encoding's scale and add, the GLU) runs in float32 and is rounded once.
The model casts its features to the compute dtype once
(models/asr_model.py).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention
from llm_guided_asr_tpu_torch.ops.rel_attention import rel_attention
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout

NEG_INF = -1.0e9  # large-negative attention bias of the dense paths


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or as it is if it is float32 or wider (float64)."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def register_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """The compute dtype as an empty, non-persistent buffer ``compute``: it
    is in no checkpoint and follows ``.double()`` (a float64 check) and
    ``.to()`` as the parameters do; ``module.compute.dtype`` reads it."""
    module.register_buffer("compute", torch.empty(0, dtype=dtype), persistent=False)


def to_compute(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` in ``module``'s compute dtype: where rows enter the model's
    blocks (the features at the encoder, as JAX ``encode`` casts them;
    encoder or LLM rows at a head or decoder, as flax's Dense casts its
    input), the one place the model casts them."""
    return x.to(module.compute.dtype)


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm``: statistics, scale and bias in float32 (at
    least), the output cast to the input's type.  The epsilon defaults to
    torch's 1e-5, as the JAX helper sets it (a bare flax LayerNorm: 1e-6).
    With ``residual`` it normalizes x + residual, the sum taken in float32
    (at least) and not rounded first (:func:`add_and_norm`)."""

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = at_least_f32(x)
        if residual is not None:
            xf = xf + at_least_f32(residual)
        y = F.layer_norm(xf, self.normalized_shape, self.weight, self.bias, self.eps)
        return y if y.dtype == x.dtype else y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm`` over channels-first [N, C, ...]: statistics,
    scale and bias in float32 (at least), the output cast to the input's
    type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(at_least_f32(x), self.num_groups, self.weight, self.bias, self.eps)
        return y if y.dtype == x.dtype else y.to(x.dtype)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1.0 + torch.exp(-x))


class _JaxSigmoid(torch.autograd.Function):
    """jax.nn.sigmoid in a 16-bit type as XLA's CPU lowering computes it:
    1 / (1 + exp(-x)), each op rounded; its derivative g * (y * sigmoid(-x))
    likewise (jax's logistic JVP)."""

    @staticmethod
    def forward(ctx, x):
        y = _logistic(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (y * _logistic(-x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid: torch's in float32 and wider; in bfloat16 the op
    sequence XLA lowers it to, each op rounded (:class:`_JaxSigmoid`)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return _JaxSigmoid.apply(x)
    return torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu = x * sigmoid(x), with :func:`sigmoid`."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x * _JaxSigmoid.apply(x)
    return F.silu(x)


def add_and_norm(x: torch.Tensor, h: torch.Tensor, norm: LayerNorm
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + h, norm(x + h)): the residual stream in x's type, and in
    bfloat16 its norm read from the sum before it rounds, as XLA's CPU
    lowering of a bfloat16 block reads the add that feeds a LayerNorm."""
    s = x + h
    if s.dtype in (torch.bfloat16, torch.float16):
        return s, norm(x, h)
    return s, norm(s)


class Dense(nn.Linear):
    """flax's ``nn.Dense`` over float32 parameters: the weight and bias cast
    to the input's type (bfloat16 in a bfloat16 model), the product in it.

    Two cases follow XLA's CPU lowering of a bfloat16 Dense, which keeps a
    product unrounded where the program casts it to float32 at once, and
    a gradient unrounded where it meets a cast from float32
    (:class:`_CastDense`):

    - ``dtype``: the compute dtype for an input of another type (a float32
      row that flax promoted): the input is cast to it inside, and the
      gradients of the input and of the parameters come back in float32;
    - ``f32_out``: the product of the rounded operands is returned in
      float32, not rounded (logits that go straight into a float32
      log-softmax or loss, k and v into the float32 WKV)."""

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                f32_out: bool = False) -> torch.Tensor:
        dtype = x.dtype if dtype is None else dtype
        if dtype != x.dtype or (f32_out and dtype in (torch.bfloat16, torch.float16)):
            return _CastDense.apply(x, self.weight, self.bias, dtype, f32_out)
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class _CastDense(torch.autograd.Function):
    """y = x.to(dtype) W.to(dtype)^T + b.to(dtype): in dtype, or the same
    product of the rounded operands in float32 (``f32_out``).  The
    backward takes the output gradient in dtype (a float32 one rounded to
    it first, as the cast's VJP rounds it) and computes in float32: dx in
    x's type, dW and db in float32, none of them rounded to dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype, f32_out):
        xc, wc = x.to(dtype), weight.to(dtype)
        bc = None if bias is None else bias.to(dtype)
        ctx.save_for_backward(xc, wc)
        ctx.x_dtype, ctx.dtype, ctx.has_bias = x.dtype, dtype, bias is not None
        if f32_out:
            return F.linear(xc.float(), wc.float(), None if bc is None else bc.float())
        return F.linear(xc, wc, bc)

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        g32 = g.to(ctx.dtype).float().reshape(-1, g.shape[-1])
        dx = (g32 @ wc.float()).reshape(*g.shape[:-1], wc.shape[1]).to(ctx.x_dtype)
        dw = g32.t() @ xc.float().reshape(-1, xc.shape[-1])
        return dx, dw, (g32.sum(0) if ctx.has_bias else None), None, None


@functools.lru_cache(maxsize=8)
def sinusoidal_pos_enc(length: int, d_model: int) -> np.ndarray:
    """Classic sinusoidal table [length, d_model] (embedding.py PositionalEncoding)."""
    position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


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
                 activation: Callable = torch.relu, dropout_rate: float = 0.1):
        super().__init__()
        self.w_1 = Dense(d_model, hidden_units)
        self.w_2 = Dense(hidden_units, d_model)
        self.activation = activation
        self.dropout_rate = dropout_rate

    def forward(self, x, rng: Optional[StepRNG] = None):
        h = dropout(self.activation(self.w_1(x)), active_rate(self, self.dropout_rate), rng)
        return self.w_2(h)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax in float32 with a valid-mask; fully masked rows become zero
    (attention.py forward_attention)."""
    if mask.dim() == 3:
        mask = mask[:, None]  # [B, 1, Tq, Tk]
    scores = scores.masked_fill(~mask, NEG_INF)
    attn = torch.softmax(scores.to(torch.promote_types(scores.dtype, torch.float32)),
                         dim=-1).to(scores.dtype)
    return attn.masked_fill(~mask, 0.0)


class MultiHeadedAttention(nn.Module):
    """Standard MHA (attention.py MultiHeadedAttention); keys and values
    may come ``kv_dim`` wide (flax infers the Dense inputs)."""

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.0,
                 kv_dim: Optional[int] = None):
        super().__init__()
        self.h, self.d_k = num_heads, d_model // num_heads
        self.linear_q = Dense(d_model, d_model)
        self.linear_k = Dense(kv_dim or d_model, d_model)
        self.linear_v = Dense(kv_dim or d_model, d_model)
        self.linear_out = Dense(d_model, d_model)
        self.dropout_rate = dropout_rate  # on the attention probabilities

    def _proj(self, x, layer):
        y = layer(x)
        return y.reshape(*y.shape[:-1], self.h, self.d_k)

    def project_kv(self, key, value) -> Tuple[torch.Tensor, torch.Tensor]:
        """k/v projections [B, Tk, H, dk] (utterance-constant cross-attention cache)."""
        return self._proj(key, self.linear_k), self._proj(value, self.linear_v)

    def forward(self, query, key, value, mask, kv_precomputed=None,
                rng: Optional[StepRNG] = None):
        q = self._proj(query, self.linear_q)
        if kv_precomputed is not None:
            k, v = kv_precomputed
        else:
            k, v = self.project_kv(key, value)
        # scaled and normalized in float32, rounded once (XLA fuses both)
        scores = at_least_f32(torch.einsum("bqhd,bkhd->bhqk", q, k)) / math.sqrt(self.d_k)
        attn = masked_softmax(scores, mask).to(v.dtype)
        attn = dropout(attn, active_rate(self, self.dropout_rate), rng)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.linear_out(out.reshape(*out.shape[:-2], self.h * self.d_k))


class RelPositionMultiHeadedAttention(nn.Module):
    """Transformer-XL relative-position MHA (attention.py RelPositionMultiHeadedAttention).

    score = ((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_k), with a
    key-padding mask.  The attention core is ops/rel_attention.py: the CUDA
    kernels for tensors on the card, the dense rel-shift path on the CPU.
    Attention-prob dropout runs inside it, keyed by an int32 seed drawn per
    call from ``rng.host``.
    """

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.h, self.d_k = num_heads, d_model // num_heads
        self.linear_q = Dense(d_model, d_model)
        self.linear_k = Dense(d_model, d_model)
        self.linear_v = Dense(d_model, d_model)
        self.linear_pos = Dense(d_model, d_model, bias=False)
        self.linear_out = Dense(d_model, d_model)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.d_k))
        self.dropout_rate = dropout_rate

    def forward(self, x, pos_emb, valid, rng: Optional[StepRNG] = None):
        """x [B, T, D]; pos_emb [1, 2T-1, D]; valid [B, T] key mask."""
        b, t, d = x.shape

        def heads(y):  # [..., T, D] -> [B, H, T, dk]
            return y.reshape(y.shape[0], y.shape[1], self.h, self.d_k).transpose(1, 2)

        q = self.linear_q(x).reshape(b, t, self.h, self.d_k)
        qu = (q + self.pos_bias_u.to(q.dtype)).transpose(1, 2).contiguous()
        qv = (q + self.pos_bias_v.to(q.dtype)).transpose(1, 2).contiguous()
        k = heads(self.linear_k(x)).contiguous()
        v = heads(self.linear_v(x)).contiguous()
        p = heads(self.linear_pos(pos_emb))[0].contiguous()  # [H, 2T-1, dk]
        rate = active_rate(self, self.dropout_rate)
        if rate > 0.0 and rng is None:
            raise ValueError("attention dropout in training mode needs a StepRNG")
        out = rel_attention(qu, qv, k, v, p, valid.to(torch.int32).contiguous(),
                            1.0 / math.sqrt(self.d_k), seed=rng.seed32() if rate > 0.0 else None,
                            dropout_rate=rate)
        return self.linear_out(out.transpose(1, 2).reshape(b, t, d))


class FlashSelfAttention(nn.Module):
    """Self-attention over the valid frames (transformer.py FlashSelfAttention),
    the long-form encoder's attention: no [B, H, T, T] scores on the card.

    For a head dim of 64, 128 or 256 the core is ops/flash_attention.py on
    every device (the CUDA kernels on the card, the plain version on the
    CPU), so the port computes the JAX module's TPU branch everywhere, pad
    query rows zeroed; for any other head dim it is the dense masked
    softmax, as the JAX module's other branch (pad rows attend the valid
    keys).  Dropout acts on the attention output, before ``linear_out``.
    """

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.h, self.d_k = num_heads, d_model // num_heads
        self.linear_q = Dense(d_model, d_model)
        self.linear_k = Dense(d_model, d_model)
        self.linear_v = Dense(d_model, d_model)
        self.linear_out = Dense(d_model, d_model)
        self.dropout_rate = dropout_rate

    def forward(self, x, valid, rng: Optional[StepRNG] = None):
        """x [B, T, D]; valid [B, T] frame mask."""
        b, t, d = x.shape

        def heads(layer):  # [B, T, D] -> [B, H, T, dk]
            return layer(x).reshape(b, t, self.h, self.d_k).transpose(1, 2).contiguous()

        q, k, v = heads(self.linear_q), heads(self.linear_k), heads(self.linear_v)
        if self.d_k in HEAD_DIMS:
            out = flash_attention(q, k, v, valid.to(torch.int32).contiguous(),
                                  1.0 / math.sqrt(self.d_k))
        else:
            scores = at_least_f32(torch.einsum("bhqd,bhkd->bhqk", q, k)) / math.sqrt(self.d_k)
            out = torch.einsum("bhqk,bhkd->bhqd",
                               masked_softmax(scores, valid[:, None, :]).to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, t, d)
        return self.linear_out(dropout(out, active_rate(self, self.dropout_rate), rng))


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + sinusoidal table, then dropout (embedding.py PositionalEncoding)."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate

    def forward(self, x, offset: int = 0, rng: Optional[StepRNG] = None):
        t, d = x.shape[1], x.shape[2]
        pe = torch.from_numpy(sinusoidal_pos_enc(offset + t, d)[offset:])
        # in float32 and rounded once, as XLA fuses the scale and the add
        x = (at_least_f32(x) * math.sqrt(d) + pe.to(x.device)[None]).to(x.dtype)
        return dropout(x, active_rate(self, self.dropout_rate), rng)


class RelPositionalEncoding(nn.Module):
    """Scale the input by sqrt(d) and emit the [1, 2T-1, D] relative table;
    dropout (one draw each) on both."""

    def __init__(self, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate

    def forward(self, x, rng: Optional[StepRNG] = None):
        t, d = x.shape[1], x.shape[2]
        pos = torch.from_numpy(rel_pos_enc(t, d)).to(device=x.device, dtype=x.dtype)[None]
        rate = active_rate(self, self.dropout_rate)
        return dropout(x * math.sqrt(d), rate, rng), dropout(pos, rate, rng)


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
        self.out = Dense(odim * f2, odim)

    def forward(self, x):
        h = torch.relu(conv_in_dtype(self.conv_0, x[:, None]))
        h = torch.relu(conv_in_dtype(self.conv_1, h))
        h = h.permute(0, 2, 3, 1)  # [B, T', F', C]
        return self.out(h.reshape(h.shape[0], h.shape[1], -1))


def conv_in_dtype(conv: nn.modules.conv._ConvNd, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (a torch Conv1d/Conv2d) in its input's type: the weight
    and bias cast to it (flax's ``nn.Conv`` with ``dtype``)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return conv._conv_forward(x, conv.weight.to(x.dtype), bias)


def sub4_frames(t: int) -> int:
    return ((t - 1) // 2 - 1) // 2


def sub4_lengths(lengths: torch.Tensor, t: Optional[int] = None) -> torch.Tensor:
    """Lengths after Conv2dSubsampling: the reference's mask arithmetic
    rounds up, (L+3)//4, clamped to the conv output width for ``t`` frames."""
    out = torch.div(lengths + 3, 4, rounding_mode="floor")
    if t is not None:
        out = torch.clamp(out, max=sub4_frames(t))
    return out


class TransformerEncoderLayer(nn.Module):
    """Pre-norm transformer encoder layer (encoder_layer.py, normalize_before):
    self-attention, then the feed-forward, each a residual branch."""

    def __init__(self, d_model: int, num_heads: int, linear_units: int,
                 dropout_rate: float = 0.1, attention_dropout_rate: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.self_attn = MultiHeadedAttention(d_model, num_heads, attention_dropout_rate)
        self.norm2 = LayerNorm(d_model)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units,
                                                    dropout_rate=dropout_rate)
        self.dropout_rate = dropout_rate

    def forward(self, x, mask, rng: Optional[StepRNG] = None):
        """x [B, T, D]; mask [B, T, T] or [B, 1, T], True = attend."""
        rate = active_rate(self, self.dropout_rate)
        h = self.norm1(x)
        x, h = add_and_norm(x, dropout(self.self_attn(h, h, h, mask, rng=rng), rate, rng),
                            self.norm2)
        return x + dropout(self.feed_forward(h, rng), rate, rng)


class DecoderLayer(nn.Module):
    """Pre-norm transformer decoder layer (decoder_layer.py): self-attn,
    src-attn over a memory ``memory_dim`` wide (default ``d_model``), FFN."""

    def __init__(self, d_model: int, num_heads: int, linear_units: int,
                 dropout_rate: float = 0.1, self_attention_dropout_rate: float = 0.0,
                 src_attention_dropout_rate: float = 0.0, memory_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(d_model)
        self.self_attn = MultiHeadedAttention(d_model, num_heads, self_attention_dropout_rate)
        self.norm2 = LayerNorm(d_model)
        self.src_attn = MultiHeadedAttention(d_model, num_heads, src_attention_dropout_rate,
                                             kv_dim=memory_dim)
        self.norm3 = LayerNorm(d_model)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units,
                                                    dropout_rate=dropout_rate)
        self.dropout_rate = dropout_rate

    def project_mem_kv(self, memory):
        """src_attn's (k, v) of the memory, computed once per utterance."""
        return self.src_attn.project_kv(memory, memory)

    def forward(self, tgt, tgt_mask, memory, memory_mask, self_kv=None, mem_kv=None,
                rng: Optional[StepRNG] = None):
        """tgt [B, Lq, D]; self_kv: optional [B, Lk, D] full key/value input
        stream (incremental decode); mem_kv: precomputed memory (k, v)."""
        rate = active_rate(self, self.dropout_rate)
        h = self.norm1(tgt)
        hk = self.norm1(self_kv) if self_kv is not None else h
        x = tgt + dropout(self.self_attn(h, hk, hk, tgt_mask, rng=rng), rate, rng)
        h = self.norm2(x)
        h = self.src_attn(h, memory, memory, memory_mask, kv_precomputed=mem_kv, rng=rng)
        x = x + dropout(h, rate, rng)
        return x + dropout(self.feed_forward(self.norm3(x), rng), rate, rng)
