"""MEGA transducer prediction network (counterpart of llm_guided_asr_tpu/models/mega_decoder.py).

Moving-average equipped gated attention (the reference's
espnet2/asr_transducer/decoder/mega_decoder.py and its blocks): per block,
a multi-head damped EMA over the sequence gates a single-head causal
attention with a relative-position bias, then a post-norm feed-forward.
The searches recompute the whole label prefix in every round, so only the
full-sequence causal forward exists (no per-hypothesis state).

The damped EMA is a causal depthwise convolution by a kernel built in log
space.  Up to ``FFT_THRESHOLD`` positions it is one product with the
[D, L, L] lower-triangular Toeplitz matrix of the kernel; above it a
zero-padded rfft/irfft (``torch.fft``) avoids that matrix.  Neither is a
TPU kernel in the JAX package.  Parameter names follow the flax modules
(``mega_0.ema.damping_factor``, ``mega_0.qk_weight``,
``mega_0.rel_pos_bias.relative_position_bias``, ``ffn_0.linear1``,
``final_norm``) so that convert.params_from_jax maps one tree onto the
other; every LayerNorm is a bare flax one, eps 1e-6.

Compute dtype: the model's (``compute`` buffer), as the JAX modules'
``dtype``: the embedding rows cast to it, every Dense and LayerNorm in its
input's type.  The EMA runs in float32 and casts its output back (JAX
models/mega_decoder.py:112-135); the query and key take the float32
``qk_weight``/``qk_bias`` and so are float32, as JAX promotes them, and
the scores and their softmax are float32, cast to the values' type
(:219-231); each post-norm reads its residual sum unrounded
(models/transformer.py add_and_norm).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.asr_model import embed_labels, register_compute_dtype
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    at_least_f32,
    sigmoid,
    silu,
)
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout

LN_EPS = 1e-6  # flax nn.LayerNorm's default
FFT_THRESHOLD = 256  # longest sequence of the Toeplitz product


class MultiHeadDampedEMA(nn.Module):
    """y[t] = sum_{j<=t} kernel[t-j] * x[j] + residual_weight * x[t], with
    kernel[d, l] = sum_n proj[d,n] / sqrt(N) * (damp * expand)[d,n] * q[d,n]^l
    and q = 1 - sigmoid(damping) * sigmoid(decay)."""

    def __init__(self, size: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.damping_factor = nn.Parameter(torch.zeros(size, num_heads))
        self.decay_factor = nn.Parameter(torch.zeros(size, num_heads))
        self.ema_expansion_matrix = nn.Parameter(torch.zeros(size, num_heads))
        self.kernel_projection_matrix = nn.Parameter(torch.zeros(size, num_heads))
        self.residual_weight = nn.Parameter(torch.zeros(size))

    def kernel(self, length: int) -> torch.Tensor:
        """The EMA kernel [D, L], the Vandermonde powers taken in log space."""
        damping = torch.sigmoid(self.damping_factor)
        q = 1.0 - damping * torch.sigmoid(self.decay_factor)
        pos = torch.arange(length, device=q.device, dtype=q.dtype)
        k = (damping * self.ema_expansion_matrix)[:, :, None] * torch.exp(
            pos[None, None, :] * torch.log(q)[:, :, None])  # [D, N, L]
        proj = self.kernel_projection_matrix * math.sqrt(1.0 / self.num_heads)
        return torch.einsum("dnl,dn->dl", k, proj)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, D] -> [B, L, D], in float32 (at least) and cast back to
        x's type."""
        length = x.shape[1]
        kern = self.kernel(length)
        xin, x = x, at_least_f32(x)
        if length <= FFT_THRESHOLD:
            idx = torch.arange(length, device=x.device)
            lag = idx[:, None] - idx[None, :]  # [L(m), L(l)] = m - l
            toep = torch.where(lag >= 0, kern[:, lag.clamp(0, length - 1)], 0.0)  # [D, L, L]
            out = torch.einsum("dml,bld->bmd", toep, x)
        else:
            n = 2 * length
            kf = torch.fft.rfft(kern, n=n, dim=-1)  # [D, n/2+1]
            xf = torch.fft.rfft(x.transpose(1, 2), n=n, dim=-1)  # [B, D, n/2+1]
            out = torch.fft.irfft(xf * kf[None], n=n, dim=-1)[..., :length].transpose(1, 2)
        return (out + x * self.residual_weight).to(xin.dtype)


class SimpleRelativePositionBias(nn.Module):
    """A learned Toeplitz bias: bias[i, j] = b[max_positions - 1 + j - i]."""

    def __init__(self, max_positions: int):
        super().__init__()
        self.max_positions = max_positions
        self.relative_position_bias = nn.Parameter(torch.zeros(2 * max_positions - 1))

    def forward(self, length: int) -> torch.Tensor:
        if length > self.max_positions:
            raise ValueError(f"sequence length {length} > max_positions {self.max_positions}")
        idx = torch.arange(length, device=self.relative_position_bias.device)
        return self.relative_position_bias[self.max_positions - 1 + idx[None, :] - idx[:, None]]


class RotaryRelativePositionBias(nn.Module):
    """rot(alpha) @ rot(beta)^T, each vector rotated by the sinusoid of its
    position ([L, L])."""

    def __init__(self, size: int, max_positions: int = 2048):
        super().__init__()
        self.size, self.max_positions = size, max_positions
        self.alpha = nn.Parameter(torch.zeros(1, size))
        self.beta = nn.Parameter(torch.zeros(1, size))

    def forward(self, length: int) -> torch.Tensor:
        if length > self.max_positions:
            raise ValueError(f"sequence length {length} > max_positions {self.max_positions}")
        half = self.size // 2
        dev = self.alpha.device
        inv = torch.exp(torch.arange(half, device=dev) * -(math.log(10000) / half))
        ang = torch.arange(length, device=dev)[:, None] * inv[None, :]
        sin, cos = torch.sin(ang), torch.cos(ang)

        def rot(v):
            v1, v2 = v.expand(length, self.size).split(half, dim=1)
            return torch.cat([v1 * cos - v2 * sin, v2 * cos + v1 * sin], dim=1)

        return rot(self.alpha) @ rot(self.beta).T


class MEGABlock(nn.Module):
    """EMA-gated single-head causal attention with a relative-position bias."""

    def __init__(self, size: int, num_heads: int, qk_size: int, v_size: int,
                 rel_pos_bias_type: str, max_positions: int, dropout_rate: float,
                 att_dropout_rate: Optional[float], ema_dropout_rate: Optional[float]):
        super().__init__()
        self.size, self.qk_size, self.v_size = size, qk_size, v_size
        self.dropout_rate = dropout_rate
        self.att_dropout_rate = dropout_rate if att_dropout_rate is None else att_dropout_rate
        self.ema_dropout_rate = dropout_rate if ema_dropout_rate is None else ema_dropout_rate
        self.proj_v = Dense(size, v_size)
        self.ema = MultiHeadDampedEMA(size, num_heads)
        self.proj_mx = Dense(size, qk_size + v_size + 2 * size)
        self.qk_weight = nn.Parameter(torch.zeros(2, qk_size))
        self.qk_bias = nn.Parameter(torch.zeros(2, qk_size))
        if rel_pos_bias_type == "rotary":
            self.rel_pos_bias = RotaryRelativePositionBias(qk_size, max_positions)
        elif rel_pos_bias_type == "simple":
            self.rel_pos_bias = SimpleRelativePositionBias(max_positions)
        else:
            raise ValueError(f"mega_rel_pos_bias={rel_pos_bias_type!r}; expected simple or rotary")
        self.proj_h = Dense(v_size, size)
        self.norm = LayerNorm(size, eps=LN_EPS)

    def forward(self, x: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        """[B, L, D] -> [B, L, D]; every position is a real label."""
        d, qk, v = self.size, self.qk_size, self.v_size
        residual = x
        value = dropout(silu(self.proj_v(x)), active_rate(self, self.dropout_rate), rng)
        ema_out = dropout(silu(self.ema(x)), active_rate(self, self.ema_dropout_rate), rng)
        base = self.proj_mx(ema_out)
        residual_weight = sigmoid(base[..., :d])
        qk_gates = silu(base[..., d: d + qk + v])
        intermediate = base[..., d + qk + v:]
        qk_x, att_gate = qk_gates[..., :qk], qk_gates[..., qk:]
        query = qk_x * self.qk_weight[0] + self.qk_bias[0]
        key = qk_x * self.qk_weight[1] + self.qk_bias[1]
        length = x.shape[1]
        scores = (torch.einsum("bld,bmd->blm", query, key) * qk ** -0.5
                  + self.rel_pos_bias(length)[None])
        causal = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
        attn = torch.softmax(torch.where(causal, scores, -1e30), dim=-1).to(value.dtype)
        attn = dropout(attn, active_rate(self, self.att_dropout_rate), rng)
        self_out = torch.einsum("blm,bmd->bld", attn, value)
        h = silu(intermediate + self.proj_h(self_out * att_gate))
        h = dropout(h, active_rate(self, self.dropout_rate), rng)
        return self.norm(residual, residual_weight * (h - residual))


class NormalizedFeedForward(nn.Module):
    """Post-norm residual feed-forward: LN(x + W2 drop(silu(W1 x)))."""

    def __init__(self, size: int, hidden_size: int, dropout_rate: float):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.linear1 = Dense(size, hidden_size)
        self.linear2 = Dense(hidden_size, size)
        self.norm = LayerNorm(size, eps=LN_EPS)

    def forward(self, x: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        rate = active_rate(self, self.dropout_rate)
        h = dropout(silu(self.linear1(x)), rate, rng)
        return self.norm(x, dropout(self.linear2(h), rate, rng))


class MEGADecoder(nn.Module):
    """labels [B, U] -> [B, U+1, H]: the blank context 0 at position 0, an
    embedding of width ``hidden_size``, ``num_layers`` (MEGA block,
    feed-forward) pairs and a final LayerNorm."""

    def __init__(self, vocab_size: int, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.cfg = cfg
        register_compute_dtype(self, dtype)
        h = cfg.hidden_size
        self.embed = nn.Embedding(vocab_size, h)
        self.n_blocks = cfg.num_layers or 4
        for i in range(self.n_blocks):
            self.add_module(f"mega_{i}", MEGABlock(
                h, cfg.mega_num_heads, cfg.mega_qk_size, cfg.mega_v_size or 2 * h,
                cfg.mega_rel_pos_bias, cfg.mega_max_positions, cfg.dropout_rate,
                cfg.mega_att_dropout_rate, cfg.mega_ema_dropout_rate))
            self.add_module(f"ffn_{i}", NormalizedFeedForward(
                h, cfg.mega_ffn_size or 2 * h, cfg.dropout_rate))
        self.final_norm = LayerNorm(h, eps=LN_EPS)

    def forward(self, labels: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        x = embed_labels(self, labels)
        x = dropout(x, active_rate(self, self.cfg.dropout_rate), rng)
        for i in range(self.n_blocks):
            x = getattr(self, f"mega_{i}")(x, rng)
            x = getattr(self, f"ffn_{i}")(x, rng)
        return self.final_norm(x)
