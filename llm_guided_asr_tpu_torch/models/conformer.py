"""Conformer encoder (counterpart of llm_guided_asr_tpu/models/conformer.py).

conv2d x4 subsampling -> rel-pos encoding -> N blocks of
[0.5*FFN (macaron) -> rel-pos MHSA -> conv module -> FFN -> LN], inference
(eval-mode) path.  The two hand-written kernels of the serving path sit in
every block: ops/rel_attention.py (self-attention) and
ops/depthwise_conv.py (conv module).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.transformer import (
    Conv2dSubsampling,
    LayerNorm,
    PositionwiseFeedForward,
    RelPositionalEncoding,
    RelPositionMultiHeadedAttention,
    sub4_lengths,
)
from llm_guided_asr_tpu_torch.ops.depthwise_conv import depthwise_conv1d
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """The fields of the JAX ConformerConfig that the eval path reads
    (dropout is off in eval mode)."""

    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
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


_ACTIVATIONS = {"swish": F.silu, "relu": torch.relu, "gelu": F.gelu, "hardtanh": F.hardtanh}


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over (batch, time), eval path: running statistics,
    applied to every frame (pads included, as the JAX module does)."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("running_mean", torch.zeros(d))
        self.register_buffer("running_var", torch.ones(d))

    def forward(self, x):
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
        h = self.activation(self.norm(h))
        return self.pointwise_conv2(h)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        if cfg.selfattention_layer_type != "rel_selfattn":
            raise NotImplementedError(
                f"selfattention_layer_type={cfg.selfattention_layer_type!r} is not ported yet"
            )
        d = cfg.output_size
        act = _ACTIVATIONS[cfg.activation_type]
        self.cfg = cfg
        if cfg.macaron_style:
            self.norm_ff_macaron = LayerNorm(d)
            self.feed_forward_macaron = PositionwiseFeedForward(d, cfg.linear_units, act)
        self.norm_mha = LayerNorm(d)
        self.self_attn = RelPositionMultiHeadedAttention(d, cfg.attention_heads)
        if cfg.use_cnn_module:
            self.norm_conv = LayerNorm(d)
            self.conv_module = ConvolutionModule(
                d, cfg.cnn_module_kernel, cfg.cnn_module_norm, act, cfg.pad_safe_conv
            )
            self.norm_final = LayerNorm(d)
        self.norm_ff = LayerNorm(d)
        self.feed_forward = PositionwiseFeedForward(d, cfg.linear_units, act)

    def forward(self, x, pos_emb, valid):
        ff_scale = 0.5 if self.cfg.macaron_style else 1.0
        if self.cfg.macaron_style:
            x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, valid)
        if self.cfg.use_cnn_module:
            x = x + self.conv_module(self.norm_conv(x), valid)
        x = x + ff_scale * self.feed_forward(self.norm_ff(x))
        if self.cfg.use_cnn_module:
            x = self.norm_final(x)
        return x


class ConformerEncoder(nn.Module):
    """[B, T, F] features -> ([B, T', D] encoded, [B] lengths); eval mode."""

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.input_layer != "conv2d" or cfg.pos_enc_layer_type != "rel_pos":
            raise NotImplementedError("only the conv2d / rel_pos Conformer is ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.embed = Conv2dSubsampling(input_size, cfg.output_size)
            self.pos_enc = RelPositionalEncoding()
            for i in range(cfg.num_blocks):
                setattr(self, f"block_{i}", ConformerBlock(cfg))
            if cfg.normalize_before:
                self.after_norm = LayerNorm(cfg.output_size)

    def forward(self, feats, feats_lengths) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embed(feats)
        out_lengths = sub4_lengths(feats_lengths, feats.shape[1])
        x, pos_emb = self.pos_enc(x)
        valid = make_valid_mask(out_lengths, x.shape[1])
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, pos_emb, valid)
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x.masked_fill(~valid[..., None], 0.0), out_lengths


def make_encoder(encoder_type: str, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda") -> nn.Module:
    """Encoder registry; the port has the Conformer so far."""
    if encoder_type == "conformer":
        return ConformerEncoder(cfg, input_size, device=device)
    raise NotImplementedError(f"encoder type {encoder_type!r} is not ported yet")
