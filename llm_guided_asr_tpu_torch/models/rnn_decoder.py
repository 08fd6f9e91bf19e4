"""RNN attention decoder (counterpart of llm_guided_asr_tpu/models/rnn_decoder.py).

ESPnet's ``--decoder rnn`` (espnet2/asr/decoder/rnn_decoder.py): a
location-aware attention (AttLoc) and stacked LSTM cells over the label
prefix, with the same ``(enc, enc_lens, ys_in, ys_in_lens) -> logits``
contract as the Transformer decoder, so the CTC/attention model, its loss
and the beam search's full-prefix scorer use it unchanged.

Each label step: the attention weights of the step before go through
``att_conv`` (a SAME conv from 1 to ``att_filters`` channels, kernel
``att_kernel``), e = ``att_v``(tanh(``att_q``(h_top) + ``enc_proj``(enc) +
``att_f``(conv))), -1e10 on pad frames, a float32 softmax; the context is
their weighted sum of the encoder rows; the clipped token's embedding and
the context go through the ``lstm_{i}`` cells (flax's
``OptimizedLSTMCell``), and ``output`` maps [h, context] to the
vocabulary.  The first weights are uniform over the valid frames.  The
attention feeds every step, so the steps run one by one in a Python loop
(the whole-sequence LSTM kernel of ops/lstm.py cannot run them).

Compute dtype: the encoder rows' (the model casts them).  The embedding,
the attention and ``output`` compute in it; the LSTM cells take no dtype
in JAX (models/rnn_decoder.py:71, ``nn.OptimizedLSTMCell`` without one),
so flax promotes their bfloat16 input to the float32 parameters: the
states are float32 and cast to the compute dtype where a Dense reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.lm import LSTMCell
from llm_guided_asr_tpu_torch.models.transformer import Dense
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG


@dataclasses.dataclass(frozen=True)
class RNNDecoderConfig:
    vocab_size: int = 100
    hidden: int = 256
    layers: int = 1
    embed_dim: int = 128
    att_dim: int = 128
    att_filters: int = 10
    att_kernel: int = 15


class AttConv(nn.Module):
    """flax ``nn.Conv(F, (K,), padding="SAME")`` over the [B, T, 1]
    attention weights: weight [K, F] (convert.py's layout of a kernel with
    one input channel), bias [F]; [B, T] -> [B, T, F]."""

    def __init__(self, filters: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_size, filters))
        self.bias = nn.Parameter(torch.zeros(filters))

    def forward(self, att_w):
        k = self.weight.shape[0]
        pad_l = (k - 1) // 2
        x = F.pad(att_w[:, None, :], (pad_l, k - 1 - pad_l))
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)  # flax casts to dtype
        return F.conv1d(x, w.t()[:, None, :], b).transpose(1, 2)


class RNNDecCell(nn.Module):
    """One label step's modules (the flax ``cell``)."""

    def __init__(self, cfg: RNNDecoderConfig, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.att_conv = AttConv(cfg.att_filters, cfg.att_kernel)
        self.att_q = Dense(cfg.hidden, cfg.att_dim, bias=False)
        self.att_f = Dense(cfg.att_filters, cfg.att_dim, bias=False)
        self.att_v = Dense(cfg.att_dim, 1, bias=False)
        for i in range(cfg.layers):
            in_features = cfg.embed_dim + enc_dim if i == 0 else cfg.hidden
            self.add_module(f"lstm_{i}", LSTMCell(cfg.hidden, in_features))
        self.output = Dense(cfg.hidden + enc_dim, cfg.vocab_size)


class RNNDecoder(nn.Module):
    """(enc [B, T, D], lengths, ys_in [B, L], lengths) -> logits [B, L, V]."""

    def __init__(self, cfg: RNNDecoderConfig, enc_dim: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.cell = RNNDecCell(cfg, enc_dim)
            self.enc_proj = Dense(enc_dim, cfg.att_dim, bias=False)

    def forward(self, enc: torch.Tensor, enc_lengths: torch.Tensor, ys_in: torch.Tensor,
                ys_in_lengths: torch.Tensor, rng: Optional[StepRNG] = None,
                only_last: bool = False) -> torch.Tensor:
        """``only_last`` keeps position len-1 of each row before ``output``."""
        cfg, cell = self.cfg, self.cell
        b, length = ys_in.shape
        enc_proj = self.enc_proj(enc)
        enc_valid = make_valid_mask(enc_lengths, enc.shape[1])
        att_w = enc_valid.float()
        att_w = (att_w / att_w.sum(-1, keepdim=True).clamp(min=1.0)).to(enc.dtype)
        stacked = [getattr(cell, f"lstm_{i}").stacked() for i in range(cfg.layers)]
        # the cells' states in their parameters' type (float32 in a
        # bfloat16 model, as flax promotes the cells)
        states = [(stacked[0][1].new_zeros(b, cfg.hidden),) * 2 for _ in range(cfg.layers)]
        emb = cell.embed(ys_in.clamp(0, cfg.vocab_size - 1)).to(enc.dtype)
        outs = []
        for t in range(length):
            f = cell.att_f(cell.att_conv(att_w))
            q = cell.att_q(states[-1][1], enc.dtype)[:, None, :]
            e = cell.att_v(torch.tanh(q + enc_proj + f))[..., 0]
            e = e.masked_fill(~enc_valid, -1e10)
            att_w = torch.softmax(e.float(), dim=-1).to(enc.dtype)
            ctx = torch.einsum("bl,bld->bd", att_w, enc)
            x = torch.cat([emb[:, t], ctx], dim=-1).to(stacked[0][0].dtype)
            for i, (w_i, w_h, b_h) in enumerate(stacked):
                c, h = states[i]
                gi, gf, gg, go = (x @ w_i.t() + (h @ w_h.t() + b_h)).chunk(4, dim=-1)
                c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
                h = torch.sigmoid(go) * torch.tanh(c)
                states[i] = (c, h)
                x = h
            # flax concatenates the float32 state and the context in float32
            outs.append(torch.cat([x, ctx.to(x.dtype)], dim=-1))
        hidden = torch.stack(outs, dim=1)
        if only_last:
            hidden = hidden[torch.arange(b, device=hidden.device), ys_in_lengths - 1]
        return cell.output(hidden, enc.dtype)
