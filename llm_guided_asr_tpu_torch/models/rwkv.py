"""RWKV prediction network of the transducer (counterpart of llm_guided_asr_tpu/models/rwkv.py).

Per block (RWKV-v4): ``x += TimeMix(LN(x)); x += ChannelMix(LN(x))``, each
mixing x with its time-shifted copy through learned per-channel weights
``mu_*``.  TimeMix runs the WKV recurrence (ops/wkv.py: the hand-written
kernels on the card).  Every LayerNorm here is a bare flax one, eps 1e-6.
Module and parameter names follow the flax modules (``block_0.att.key``,
``mu_k``, ``time_decay`` ...) so that convert.params_from_jax maps one
tree onto the other.

Compute dtype: the model's (``compute`` buffer, float32 or bfloat16), as
the JAX modules' ``dtype``: the embedding rows cast to it, every Dense and
LayerNorm in its input's type.  The token-shift mixes multiply by float32
``mu_*`` parameters and so run in float32, as JAX promotes them, until the
next Dense casts them; WKV takes k and v in float32 and returns y in k's
type (ops/wkv.py, JAX ops/wkv.py:153-155), with w and u float32.  Every
other bfloat16 op rounds its result, as the JAX module's compiled CPU
graph does, but the residual add that ``ln2`` reads (models/transformer.py
add_and_norm).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.asr_model import embed_labels, register_compute_dtype
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    add_and_norm,
    at_least_f32,
    sigmoid,
)
from llm_guided_asr_tpu_torch.ops.wkv import wkv
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _time_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> the previous step's x (zeros at t=0)."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def _mix(x: torch.Tensor, xp: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """x and its shifted copy mixed by the float32 ``mu``: float32 (at
    least) for a bfloat16 x, as JAX promotes ``x * mu_k`` (JAX
    models/rwkv.py:42-44)."""
    return x * mu + xp * (1 - mu)


class TimeMix(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        c = hidden
        self.mu_k, self.mu_v, self.mu_r = (nn.Parameter(torch.zeros(c)) for _ in range(3))
        self.key = Dense(c, c, bias=False)
        self.value = Dense(c, c, bias=False)
        self.receptance = Dense(c, c, bias=False)
        self.time_decay = nn.Parameter(torch.zeros(c))
        self.time_first = nn.Parameter(torch.zeros(c))
        self.output = Dense(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = _time_shift(x)
        # k and v in float32, unrounded: the WKV casts them so at once (JAX
        # ops/wkv.py:153-154), and y back to the compute dtype (:155)
        k = self.key(_mix(x, xp, self.mu_k), x.dtype, f32_out=True)
        v = self.value(_mix(x, xp, self.mu_v), x.dtype, f32_out=True)
        r = sigmoid(self.receptance(_mix(x, xp, self.mu_r), x.dtype))
        w = -torch.exp(self.time_decay.float())  # the decay's sign, as wkv_cuda.cu
        y = wkv(w, self.time_first.float(), k, v)
        if y.dtype == x.dtype:
            return self.output(r * y)
        # y rounded to the compute dtype, its gradient left float32 (the VJP
        # of JAX's cast, ops/wkv.py:155, hands it on unrounded); r * y
        # rounded once
        y = y + (y.to(x.dtype).to(y.dtype) - y).detach()
        return self.output((at_least_f32(r) * y).to(x.dtype))


class ChannelMix(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        c = hidden
        self.mu_k, self.mu_r = (nn.Parameter(torch.zeros(c)) for _ in range(2))
        self.key = Dense(c, 4 * c, bias=False)
        self.receptance = Dense(c, c, bias=False)
        self.value = Dense(4 * c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = _time_shift(x)
        k = self.key(_mix(x, xp, self.mu_k), x.dtype)
        r = sigmoid(self.receptance(_mix(x, xp, self.mu_r), x.dtype))
        return r * self.value(torch.square(torch.relu(k)))


class RWKVBlock(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.ln1 = LayerNorm(hidden, eps=LN_EPS)
        self.att = TimeMix(hidden)
        self.ln2 = LayerNorm(hidden, eps=LN_EPS)
        self.ffn = ChannelMix(hidden)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x + residual, the channel mix's output): the caller adds the
        latter, so that the next norm reads the sum unrounded
        (models/transformer.py add_and_norm)."""
        if residual is None:
            h = self.ln1(x)
        else:
            x, h = add_and_norm(x, residual, self.ln1)
        x, h = add_and_norm(x, self.att(h), self.ln2)
        return x, self.ffn(h)


class RWKVDecoder(nn.Module):
    """[B, U] labels -> [B, U+1, H]: position 0 is the blank context 0;
    labels are clipped into the vocabulary
    (asr_transducer/decoder/rwkv_decoder.py)."""

    def __init__(self, vocab_size: int, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg.hidden_size
        self.vocab_size = vocab_size
        self.cfg = cfg
        register_compute_dtype(self, dtype)
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        if cfg.embed_size != c:
            self.proj = Dense(cfg.embed_size, c)
        self.ln_in = LayerNorm(c, eps=LN_EPS)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", RWKVBlock(c))
        self.ln_out = LayerNorm(c, eps=LN_EPS)

    def forward(self, labels: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        x = embed_labels(self, labels)
        if self.cfg.embed_size != self.cfg.hidden_size:
            x = self.proj(x)
        x, residual = self.ln_in(x), None
        for i in range(self.cfg.num_layers):
            x, residual = getattr(self, f"block_{i}")(x, residual)
        x = self.ln_out(x, residual)
        return dropout(x, active_rate(self, self.cfg.dropout_rate), rng)
