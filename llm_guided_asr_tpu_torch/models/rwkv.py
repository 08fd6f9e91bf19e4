"""RWKV prediction network of the transducer (counterpart of llm_guided_asr_tpu/models/rwkv.py).

Per block (RWKV-v4): ``x += TimeMix(LN(x)); x += ChannelMix(LN(x))``, each
mixing x with its time-shifted copy through learned per-channel weights
``mu_*``.  TimeMix runs the WKV recurrence (ops/wkv.py: the hand-written
kernels on the card).  Every LayerNorm here is a bare flax one, eps 1e-6.
Module and parameter names follow the flax modules (``block_0.att.key``,
``mu_k``, ``time_decay`` ...) so that convert.params_from_jax maps one
tree onto the other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.ops.wkv import wkv
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _time_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> the previous step's x (zeros at t=0)."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def _mix(x: torch.Tensor, xp: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x * mu + xp * (1 - mu)


class TimeMix(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        c = hidden
        self.mu_k, self.mu_v, self.mu_r = (nn.Parameter(torch.zeros(c)) for _ in range(3))
        self.key = nn.Linear(c, c, bias=False)
        self.value = nn.Linear(c, c, bias=False)
        self.receptance = nn.Linear(c, c, bias=False)
        self.time_decay = nn.Parameter(torch.zeros(c))
        self.time_first = nn.Parameter(torch.zeros(c))
        self.output = nn.Linear(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = _time_shift(x)
        k = self.key(_mix(x, xp, self.mu_k))
        v = self.value(_mix(x, xp, self.mu_v))
        r = torch.sigmoid(self.receptance(_mix(x, xp, self.mu_r)))
        w = -torch.exp(self.time_decay.float())  # the decay's sign, as wkv_cuda.cu
        y = wkv(w, self.time_first.float(), k, v)
        return self.output(r * y)


class ChannelMix(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        c = hidden
        self.mu_k, self.mu_r = (nn.Parameter(torch.zeros(c)) for _ in range(2))
        self.key = nn.Linear(c, 4 * c, bias=False)
        self.receptance = nn.Linear(c, c, bias=False)
        self.value = nn.Linear(4 * c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xp = _time_shift(x)
        k = self.key(_mix(x, xp, self.mu_k))
        r = torch.sigmoid(self.receptance(_mix(x, xp, self.mu_r)))
        return r * self.value(torch.square(torch.relu(k)))


class RWKVBlock(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.att = TimeMix(hidden)
        self.ln2 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn = ChannelMix(hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.att(self.ln1(x))
        return x + self.ffn(self.ln2(x))


class RWKVDecoder(nn.Module):
    """[B, U] labels -> [B, U+1, H]: position 0 is the blank context 0;
    labels are clipped into the vocabulary
    (asr_transducer/decoder/rwkv_decoder.py)."""

    def __init__(self, vocab_size: int, cfg):
        super().__init__()
        c = cfg.hidden_size
        self.vocab_size = vocab_size
        self.cfg = cfg
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        if cfg.embed_size != c:
            self.proj = nn.Linear(cfg.embed_size, c)
        self.ln_in = nn.LayerNorm(c, eps=LN_EPS)
        for i in range(cfg.num_layers):
            setattr(self, f"block_{i}", RWKVBlock(c))
        self.ln_out = nn.LayerNorm(c, eps=LN_EPS)

    def forward(self, labels: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        y = torch.cat([torch.zeros_like(labels[:, :1]), labels], dim=1)
        x = self.embed(y.clamp(0, self.vocab_size - 1))
        if self.cfg.embed_size != self.cfg.hidden_size:
            x = self.proj(x)
        x = self.ln_in(x)
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_out(x)
        return dropout(x, active_rate(self, self.cfg.dropout_rate), rng)
