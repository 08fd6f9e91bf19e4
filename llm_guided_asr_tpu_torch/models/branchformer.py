"""Branchformer and E-Branchformer encoders (counterpart of llm_guided_asr_tpu/models/branchformer.py).

Each block runs two branches side by side over the same input: the
self-attention (rel-pos MHA over the ``rel_pos`` table, dense MHA
otherwise) and the convolutional gating MLP (cgMLP).  The E-Branchformer
block wraps them in macaron half-step FFNs (relu, whatever
``activation_type`` says) and merges them by concatenation, a grouped
conv of kernel 3 and a projection; the Branchformer block averages them
with the softmax of two learned weights.  The encoders are the input layer
(``conv2d``, ``linear`` or ``none``), the positional encoding and N
blocks, with no ``after_norm`` and no intermediate-CTC taps.  The
hand-written kernels sit in every block: ops/rel_attention.py (the
attention branch over the rel-pos table) and ops/depthwise_conv.py (the
cgMLP's depthwise conv, ``linear_units / 2`` channels), forward and
backward.  Every LayerNorm takes eps 1e-5.

Compute dtype: the features' (the model casts them); every Dense, conv and
LayerNorm computes in it (flax's ``dtype``), the kernels on their bfloat16
entries in a bfloat16 model.  A LayerNorm that reads a residual add
normalizes the unrounded sum (models/transformer.py add_and_norm).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import (
    ConformerConfig,
    DepthwiseConv1d,
    embed_features,
    gelu_tanh,
    input_layer,
)
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    MultiHeadedAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RelPositionalEncoding,
    RelPositionMultiHeadedAttention,
    add_and_norm,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout

# the JAX block fixes the merge conv's kernel at 3 (ESPnet's recipes set 31)
MERGE_KERNEL = 3


class ConvolutionalGatingMLP(nn.Module):
    """cgMLP (espnet2/asr/layers/cgmlp.py): ``channel_proj1`` -> tanh GELU
    -> halves a, b -> a * depthwise_conv(LayerNorm(b), pads zeroed) ->
    dropout -> ``channel_proj2``.  The pads are zeroed before the conv
    whatever ``pad_safe_conv`` says, as in JAX."""

    def __init__(self, d: int, linear_units: int, kernel_size: int, dropout_rate: float):
        super().__init__()
        half = linear_units // 2
        self.channel_proj1 = Dense(d, linear_units)
        self.norm = LayerNorm(half)
        self.depthwise_conv = DepthwiseConv1d(half, kernel_size)
        self.channel_proj2 = Dense(half, d)
        self.dropout_rate = dropout_rate

    def forward(self, x, valid, rng: Optional[StepRNG] = None):
        a, b = gelu_tanh(self.channel_proj1(x)).chunk(2, dim=-1)
        g = self.norm(b).masked_fill(~valid[..., None], 0.0)
        h = a * self.depthwise_conv(g.contiguous())
        return self.channel_proj2(dropout(h, active_rate(self, self.dropout_rate), rng))


class GroupedConv1d(nn.Module):
    """flax ``nn.Conv(C, (K,), padding="SAME", feature_group_count=C)``
    over [B, T, C] with bias: weight [K, C] (convert.py's depthwise
    layout), computed by F.conv1d in its input's type as JAX computes it by
    XLA's grouped conv, not by the depthwise kernel."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        k, c = self.weight.shape
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype).t()[:, None, :],
                     self.bias.to(x.dtype), padding=(k - 1) // 2, groups=c)
        return y.transpose(1, 2)


def _attention(cfg: ConformerConfig, d: int) -> nn.Module:
    """rel-pos MHA for ``rel_selfattn`` over a ``rel_pos`` table, dense MHA
    for anything else (the JAX block's fall-through)."""
    if cfg.selfattention_layer_type == "rel_selfattn" and cfg.pos_enc_layer_type == "rel_pos":
        return RelPositionMultiHeadedAttention(d, cfg.attention_heads, cfg.attention_dropout_rate)
    return MultiHeadedAttention(d, cfg.attention_heads, cfg.attention_dropout_rate)


def _attend(attn: nn.Module, h, pos_emb, valid, rng):
    if isinstance(attn, RelPositionMultiHeadedAttention):
        return attn(h, pos_emb, valid, rng)
    return attn(h, h, h, valid[:, None, :], rng=rng)


class EBranchformerBlock(nn.Module):
    """0.5 * FFN -> [attention || cgMLP] -> concat, pads zeroed, + grouped
    conv, ``merge_proj`` -> 0.5 * FFN -> ``norm_final``."""

    def __init__(self, cfg: ConformerConfig, d: int):
        super().__init__()
        self.cfg = cfg
        self.norm_ff1 = LayerNorm(d)
        self.feed_forward1 = PositionwiseFeedForward(d, cfg.linear_units, torch.relu,
                                                     cfg.dropout_rate)
        self.norm_mha = LayerNorm(d)
        self.attn = _attention(cfg, d)
        self.norm_mlp = LayerNorm(d)
        self.cgmlp = ConvolutionalGatingMLP(d, cfg.linear_units, cfg.cnn_module_kernel,
                                            cfg.dropout_rate)
        self.merge_conv = GroupedConv1d(2 * d, MERGE_KERNEL)
        self.merge_proj = Dense(2 * d, d)
        self.norm_ff2 = LayerNorm(d)
        self.feed_forward2 = PositionwiseFeedForward(d, cfg.linear_units, torch.relu,
                                                     cfg.dropout_rate)
        self.norm_final = LayerNorm(d)

    def forward(self, x, pos_emb, valid, rng: Optional[StepRNG] = None):
        rate = active_rate(self, self.cfg.dropout_rate)
        h = 0.5 * dropout(self.feed_forward1(self.norm_ff1(x), rng), rate, rng)
        ha = dropout(_attend(self.attn, self.norm_mha(x, h), pos_emb, valid, rng), rate, rng)
        hc = dropout(self.cgmlp(self.norm_mlp(x, h), valid, rng), rate, rng)
        x = x + h
        cat = torch.cat([ha, hc], dim=-1).masked_fill(~valid[..., None], 0.0)
        x, h = add_and_norm(x, dropout(self.merge_proj(cat + self.merge_conv(cat)), rate, rng),
                            self.norm_ff2)
        return self.norm_final(x, 0.5 * dropout(self.feed_forward2(h, rng), rate, rng))


class BranchformerBlock(nn.Module):
    """x + dropout(w0 * attention + w1 * cgMLP), w = softmax(``branch_weights``)
    (zeros at JAX's init), then ``norm_final``."""

    def __init__(self, cfg: ConformerConfig, d: int):
        super().__init__()
        self.cfg = cfg
        self.norm_mha = LayerNorm(d)
        self.attn = _attention(cfg, d)
        self.norm_mlp = LayerNorm(d)
        self.cgmlp = ConvolutionalGatingMLP(d, cfg.linear_units, cfg.cnn_module_kernel,
                                            cfg.dropout_rate)
        self.branch_weights = nn.Parameter(torch.zeros(2))
        self.norm_final = LayerNorm(d)

    def forward(self, x, pos_emb, valid, rng: Optional[StepRNG] = None):
        ha = _attend(self.attn, self.norm_mha(x), pos_emb, valid, rng)
        hc = self.cgmlp(self.norm_mlp(x), valid, rng)
        w = torch.softmax(self.branch_weights, dim=0)
        merged = w[0] * ha + w[1] * hc
        return self.norm_final(x, dropout(merged, active_rate(self, self.cfg.dropout_rate), rng))


class EBranchformerEncoder(nn.Module):
    """[B, T, F] features -> ([B, T', D] encoded, [B] lengths)."""

    block_type = EBranchformerBlock

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.embed, d = input_layer(cfg.input_layer, input_size, cfg.output_size)
            self.output_size = d
            if cfg.pos_enc_layer_type == "rel_pos":
                self.pos_enc = RelPositionalEncoding(cfg.positional_dropout_rate)
            else:
                self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
            for i in range(cfg.num_blocks):
                setattr(self, f"block_{i}", self.block_type(cfg, d))

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, out_lengths = embed_features(self, feats, feats_lengths)
        if self.cfg.pos_enc_layer_type == "rel_pos":
            x, pos_emb = self.pos_enc(x, rng)
        else:
            x, pos_emb = self.pos_enc(x, rng=rng), None
        valid = make_valid_mask(out_lengths, x.shape[1])
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, pos_emb, valid, rng)
        return x.masked_fill(~valid[..., None], 0.0), out_lengths


class BranchformerEncoder(EBranchformerEncoder):
    block_type = BranchformerBlock
