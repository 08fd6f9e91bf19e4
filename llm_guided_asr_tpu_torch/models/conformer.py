"""Conformer encoder (counterpart of llm_guided_asr_tpu/models/conformer.py).

conv2d x4 subsampling -> positional encoding -> N blocks of
[0.5*FFN (macaron) -> MHSA -> conv module -> FFN -> LN].  The self-attention
is ``selfattention_layer_type``: ``rel_selfattn`` (Transformer-XL, over the
``rel_pos`` table), ``flash`` (the long-form encoder: flash attention over
the valid frames, usually with ``abs_pos``) or ``selfattn`` (dense MHA with
a key mask).  ``.eval()`` is the serving path (running BN statistics, no
dropout); ``.train()`` the training path (masked batch statistics with the
running update, dropout from the ``rng`` the forward takes).  The
hand-written kernels sit in every block: ops/rel_attention.py or
ops/flash_attention.py (self-attention) and ops/depthwise_conv.py (conv
module), forward and backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.transformer import (
    Conv2dSubsampling,
    FlashSelfAttention,
    LayerNorm,
    MultiHeadedAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RelPositionalEncoding,
    RelPositionMultiHeadedAttention,
    sub4_lengths,
)
from llm_guided_asr_tpu_torch.ops.depthwise_conv import depthwise_conv1d
from llm_guided_asr_tpu_torch.ops.masked_bn import masked_batch_norm
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """The fields of the JAX ConformerConfig that the Conformer reads."""

    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.0
    input_layer: str = "conv2d"
    normalize_before: bool = True
    macaron_style: bool = False
    pos_enc_layer_type: str = "rel_pos"
    selfattention_layer_type: str = "rel_selfattn"
    activation_type: str = "swish"
    use_cnn_module: bool = True
    cnn_module_kernel: int = 31
    cnn_module_norm: str = "batch_norm"
    # True: zero pad frames before the depthwise conv (batch-width
    # invariant); False: convolve pads as the reference does
    pad_safe_conv: bool = True
    interctc_layer_idx: Tuple[int, ...] = ()  # 1-based blocks tapped for intermediate CTC
    # the contextual-block (streaming) encoder only: sub-frames a block
    block_size: int = 40


_ACTIVATIONS = {"swish": F.silu, "relu": torch.relu, "gelu": F.gelu, "hardtanh": F.hardtanh}
_ATTENTIONS = {"rel_selfattn": RelPositionMultiHeadedAttention, "flash": FlashSelfAttention,
               "selfattn": MultiHeadedAttention}


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (batch, time), applied to every frame (pads
    included, as the JAX module does).  Eval: running statistics.  Train:
    statistics of the valid frames (ops/masked_bn.py), and the running ones
    move towards them with momentum 0.9 (biased variance, as in JAX)."""

    def __init__(self, d: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("running_mean", torch.zeros(d))
        self.register_buffer("running_var", torch.ones(d))

    def forward(self, x, valid):
        if self.training:
            y, mean, var = masked_batch_norm(x, valid, self.weight, self.bias, self.eps)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * var)
            return y
        inv = torch.rsqrt(self.running_var + self.eps)
        y = (x.float() - self.running_mean) * inv * self.weight + self.bias
        return y.to(x.dtype)


class DepthwiseConv1d(nn.Module):
    """Depthwise conv over [B, T, C]: weight [K, C], bias [C]."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return depthwise_conv1d(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class ConvolutionModule(nn.Module):
    """pw-conv -> GLU -> depthwise conv -> norm -> activation -> pw-conv
    (espnet conformer/convolution.py)."""

    def __init__(self, d: int, kernel_size: int, norm_type: str, activation, mask_pads: bool):
        super().__init__()
        self.pointwise_conv1 = nn.Linear(d, 2 * d)
        self.depthwise_conv = DepthwiseConv1d(d, kernel_size)
        self.norm = MaskedBatchNorm(d) if norm_type == "batch_norm" else LayerNorm(d)
        self.pointwise_conv2 = nn.Linear(d, d)
        self.activation = activation
        self.mask_pads = mask_pads

    def forward(self, x, valid):
        h = self.pointwise_conv1(x)
        a, gate = h.chunk(2, dim=-1)
        h = a * torch.sigmoid(gate)  # flax nn.glu: first half x sigmoid(second)
        if self.mask_pads:
            h = h.masked_fill(~valid[..., None], 0.0)
        h = self.depthwise_conv(h.contiguous())
        h = self.norm(h, valid) if isinstance(self.norm, MaskedBatchNorm) else self.norm(h)
        h = self.activation(h)
        return self.pointwise_conv2(h)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        attn_type = _ATTENTIONS.get(cfg.selfattention_layer_type)
        if attn_type is None:
            raise ValueError(f"selfattention_layer_type={cfg.selfattention_layer_type!r}; "
                             f"expected one of {sorted(_ATTENTIONS)}")
        d = cfg.output_size
        act = _ACTIVATIONS[cfg.activation_type]
        self.cfg = cfg
        if cfg.macaron_style:
            self.norm_ff_macaron = LayerNorm(d)
            self.feed_forward_macaron = PositionwiseFeedForward(d, cfg.linear_units, act,
                                                                cfg.dropout_rate)
        self.norm_mha = LayerNorm(d)
        self.self_attn = attn_type(d, cfg.attention_heads, cfg.attention_dropout_rate)
        if cfg.use_cnn_module:
            self.norm_conv = LayerNorm(d)
            self.conv_module = ConvolutionModule(
                d, cfg.cnn_module_kernel, cfg.cnn_module_norm, act, cfg.pad_safe_conv
            )
            self.norm_final = LayerNorm(d)
        self.norm_ff = LayerNorm(d)
        self.feed_forward = PositionwiseFeedForward(d, cfg.linear_units, act, cfg.dropout_rate)

    def forward(self, x, pos_emb, valid, rng: Optional[StepRNG] = None):
        cfg = self.cfg
        rate = active_rate(self, cfg.dropout_rate)
        ff_scale = 0.5 if cfg.macaron_style else 1.0
        if cfg.macaron_style:
            h = self.feed_forward_macaron(self.norm_ff_macaron(x), rng)
            x = x + 0.5 * dropout(h, rate, rng)
        h = self.norm_mha(x)
        if cfg.selfattention_layer_type == "rel_selfattn":
            h = self.self_attn(h, pos_emb, valid, rng)
        elif cfg.selfattention_layer_type == "flash":
            h = self.self_attn(h, valid, rng)
        else:
            h = self.self_attn(h, h, h, valid[:, None, :], rng=rng)
        x = x + dropout(h, rate, rng)
        if cfg.use_cnn_module:
            x = x + dropout(self.conv_module(self.norm_conv(x), valid), rate, rng)
        x = x + ff_scale * dropout(self.feed_forward(self.norm_ff(x), rng), rate, rng)
        if self.cfg.use_cnn_module:
            x = self.norm_final(x)
        return x


class ConformerEncoder(nn.Module):
    """[B, T, F] features -> ([B, T', D] encoded, [B] lengths)."""

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.input_layer != "conv2d":
            raise NotImplementedError(f"input_layer={cfg.input_layer!r} is not ported yet")
        if cfg.pos_enc_layer_type not in ("rel_pos", "abs_pos"):
            raise ValueError(f"pos_enc_layer_type={cfg.pos_enc_layer_type!r}")
        if cfg.selfattention_layer_type == "rel_selfattn" and cfg.pos_enc_layer_type != "rel_pos":
            raise ValueError("rel_selfattn needs pos_enc_layer_type='rel_pos'")
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.embed = Conv2dSubsampling(input_size, cfg.output_size)
            if cfg.pos_enc_layer_type == "rel_pos":
                self.pos_enc = RelPositionalEncoding(cfg.positional_dropout_rate)
            else:
                self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
            for i in range(cfg.num_blocks):
                setattr(self, f"block_{i}", ConformerBlock(cfg))
            if cfg.normalize_before:
                self.after_norm = LayerNorm(cfg.output_size)

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, lengths, _ = self.forward_with_intermediates(feats, feats_lengths, rng)
        return x, lengths

    def forward_with_intermediates(self, feats, feats_lengths, rng: Optional[StepRNG] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        """As ``forward``, plus the outputs of the ``interctc_layer_idx``
        blocks (1-based), pad frames zeroed (the intermediate-CTC taps)."""
        x = self.embed(feats)
        out_lengths = sub4_lengths(feats_lengths, feats.shape[1])
        if self.cfg.pos_enc_layer_type == "rel_pos":
            x, pos_emb = self.pos_enc(x, rng)
        else:
            x, pos_emb = self.pos_enc(x, rng=rng), None
        valid = make_valid_mask(out_lengths, x.shape[1])
        taps = []
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, pos_emb, valid, rng)
            if i + 1 in self.cfg.interctc_layer_idx:
                taps.append(x.masked_fill(~valid[..., None], 0.0))
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x.masked_fill(~valid[..., None], 0.0), out_lengths, tuple(taps)


def make_encoder(encoder_type: str, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda") -> nn.Module:
    """Encoder registry: the Conformer and the contextual-block
    (streaming) Conformer of models/streaming.py so far."""
    if encoder_type == "conformer":
        return ConformerEncoder(cfg, input_size, device=device)
    if encoder_type == "contextual_block_conformer":
        from llm_guided_asr_tpu_torch.models.streaming import ContextualBlockConformerEncoder

        return ContextualBlockConformerEncoder(cfg, input_size, block_size=cfg.block_size,
                                               device=device)
    raise NotImplementedError(f"encoder type {encoder_type!r} is not ported yet")
