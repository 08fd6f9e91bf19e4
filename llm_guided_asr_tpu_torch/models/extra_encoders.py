"""MultiConvformer and (VGG-)RNN encoders (counterpart of llm_guided_asr_tpu/models/extra_encoders.py).

- :class:`MultiConvformerEncoder` (espnet2/asr/encoder/multiconvformer_encoder.py):
  a Conformer whose convolution module is a multi-kernel convolutional
  gating MLP (:class:`MultiConvCGMLP`, ``concat_fusion`` of the
  ``multicgmlp_kernel_sizes`` depthwise convs, then a merge depthwise conv
  of kernel 31 over their concatenation).  Every depthwise conv is the
  hand-written kernel of ops/depthwise_conv.py, forward and backward: five
  launches a block at the default four kernel sizes, the merge at 4 x
  ``linear_units / 2`` channels; the self-attention is the rel-pos kernel
  under ``rel_selfattn``.
- :class:`RNNEncoder` (espnet2/asr/encoder/rnn_encoder.py and
  vgg_rnn_encoder.py): VGG2L (``vgg_rnn`` under ``conv2d``: two stages of
  two 3x3 convs with ReLU and a 2x2 max pool, lengths // 4) or one Dense,
  then ``num_blocks`` bidirectional LSTM layers of ``output_size`` units,
  each direction one input-projection GEMM and one launch of the LSTM
  recurrence kernel (ops/lstm.py), and a tanh(Dense) projection a layer.
  The backward direction is flax's ``nn.RNN(reverse=True,
  keep_order=True)`` without ``seq_lengths``: it runs over the whole
  padded sequence from the padded end, so the port flips the padded
  tensor, runs the same recurrence and flips back.  The flax cells are
  auto-named ``OptimizedLSTMCell_{2i}`` (forward) and
  ``OptimizedLSTMCell_{2i+1}`` (backward) at the encoder's top level.

Every LayerNorm takes eps 1e-5; the GELU is the tanh form.

Compute dtype: the features' (the model casts them).  Every Dense, conv
and LayerNorm computes in it, the depthwise convs on the kernel's
bfloat16 entry in a bfloat16 model; a LayerNorm that reads a residual add
normalizes the unrounded sum (models/transformer.py add_and_norm).  The
(VGG-)RNN encoder's LSTM cells take no dtype in JAX
(models/extra_encoders.py:198-199, ``nn.OptimizedLSTMCell`` without one),
so flax promotes their input to the float32 parameters: each direction's
recurrence runs on the kernel's float32 entry, and the projection casts
the concatenated states back to the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import (
    _ACTIVATIONS,
    ConformerConfig,
    DepthwiseConv1d,
    embed_features,
    gelu_tanh,
    input_layer,
    refuse_no_input_layer,
)
from llm_guided_asr_tpu_torch.models.lm import LSTMCell, lstm_stack
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    MultiHeadedAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RelPositionalEncoding,
    RelPositionMultiHeadedAttention,
    add_and_norm,
    at_least_f32,
    conv_in_dtype,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout

MERGE_KERNEL = 31


class MultiConvCGMLP(nn.Module):
    """``channel_proj1`` -> tanh GELU -> halves a, b -> g = LayerNorm(b),
    pads zeroed -> the depthwise convs ``depthwise_conv_{i}`` of g,
    concatenated, pads zeroed -> ``merge_conv`` -> ``merge_proj`` -> a * m
    -> dropout -> ``channel_proj2``."""

    def __init__(self, d: int, linear_units: int, kernel_sizes: Sequence[int],
                 dropout_rate: float):
        super().__init__()
        half = linear_units // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.channel_proj1 = Dense(d, linear_units)
        self.norm = LayerNorm(half)
        for i, k in enumerate(self.kernel_sizes):
            self.add_module(f"depthwise_conv_{i}", DepthwiseConv1d(half, k))
        self.merge_conv = DepthwiseConv1d(half * len(self.kernel_sizes), MERGE_KERNEL)
        self.merge_proj = Dense(half * len(self.kernel_sizes), half)
        self.channel_proj2 = Dense(half, d)
        self.dropout_rate = dropout_rate

    def forward(self, x, valid, rng: Optional[StepRNG] = None):
        pad = ~valid[..., None]
        a, b = gelu_tanh(self.channel_proj1(x)).chunk(2, dim=-1)
        g = self.norm(b).masked_fill(pad, 0.0).contiguous()
        m = torch.cat([getattr(self, f"depthwise_conv_{i}")(g)
                       for i in range(len(self.kernel_sizes))], dim=-1)
        m = self.merge_proj(self.merge_conv(m.masked_fill(pad, 0.0).contiguous()))
        h = dropout(a * m, active_rate(self, self.dropout_rate), rng)
        return self.channel_proj2(h)


class MultiConvformerBlock(nn.Module):
    """[0.5 * FFN (macaron)] -> MHSA -> MultiConvCGMLP -> FFN (x 0.5 under
    macaron), each pre-norm; ``norm_final`` only when not
    ``normalize_before``."""

    def __init__(self, cfg: ConformerConfig, d: int):
        super().__init__()
        act = _ACTIVATIONS[cfg.activation_type]
        self.cfg = cfg
        if cfg.macaron_style:
            self.norm_ff_macaron = LayerNorm(d)
            self.feed_forward_macaron = PositionwiseFeedForward(d, cfg.linear_units, act,
                                                                cfg.dropout_rate)
        self.norm_mha = LayerNorm(d)
        self.rel = cfg.selfattention_layer_type == "rel_selfattn"
        attn = RelPositionMultiHeadedAttention if self.rel else MultiHeadedAttention
        self.self_attn = attn(d, cfg.attention_heads, cfg.attention_dropout_rate)
        self.norm_conv = LayerNorm(d)
        self.cgmlp = MultiConvCGMLP(d, cfg.linear_units, cfg.multicgmlp_kernel_sizes,
                                    cfg.dropout_rate)
        self.norm_ff = LayerNorm(d)
        self.feed_forward = PositionwiseFeedForward(d, cfg.linear_units, act, cfg.dropout_rate)
        if not cfg.normalize_before:
            self.norm_final = LayerNorm(d)

    def forward(self, x, pos_emb, valid, rng: Optional[StepRNG] = None):
        cfg = self.cfg
        rate = active_rate(self, cfg.dropout_rate)
        if cfg.macaron_style:
            h = self.feed_forward_macaron(self.norm_ff_macaron(x), rng)
            x, h = add_and_norm(x, 0.5 * dropout(h, rate, rng), self.norm_mha)
        else:
            h = self.norm_mha(x)
        if self.rel:
            h = self.self_attn(h, pos_emb, valid, rng)
        else:
            h = self.self_attn(h, h, h, valid[:, None, :], rng=rng)
        x, h = add_and_norm(x, dropout(h, rate, rng), self.norm_conv)
        x, h = add_and_norm(x, dropout(self.cgmlp(h, valid, rng), rate, rng), self.norm_ff)
        scale = 0.5 if cfg.macaron_style else 1.0
        h = scale * dropout(self.feed_forward(h, rng), rate, rng)
        return x + h if cfg.normalize_before else self.norm_final(x, h)


class MultiConvformerEncoder(nn.Module):
    """[B, T, F] features -> ([B, T', D], [B] lengths), pads zeroed."""

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.selfattention_layer_type == "rel_selfattn" and cfg.pos_enc_layer_type != "rel_pos":
            raise ValueError("rel_selfattn needs pos_enc_layer_type='rel_pos'")
        refuse_no_input_layer(cfg)
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            self.embed, d = input_layer(cfg.input_layer, input_size, cfg.output_size)
            self.output_size = d
            if cfg.pos_enc_layer_type == "rel_pos":
                self.pos_enc = RelPositionalEncoding(cfg.positional_dropout_rate)
            else:
                self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
            for i in range(cfg.num_blocks):
                setattr(self, f"block_{i}", MultiConvformerBlock(cfg, d))
            if cfg.normalize_before:
                self.after_norm = LayerNorm(d)

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
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x.masked_fill(~valid[..., None], 0.0), out_lengths


class VGG2L(nn.Module):
    """Two stages of [3x3 conv, ReLU, 3x3 conv, ReLU, 2x2 max pool] (64 and
    128 channels, SAME padding): [B, T, F] -> [B, T // 4, (F // 4) * 128],
    flattened with the channels minor as flax's NHWC reshape; each conv in
    its input's type (flax's ``nn.Conv`` with ``dtype``)."""

    def __init__(self):
        super().__init__()
        c_in = 1
        for i, ch in enumerate((64, 128)):
            self.add_module(f"conv{i}_1", nn.Conv2d(c_in, ch, 3, padding=1))
            self.add_module(f"conv{i}_2", nn.Conv2d(ch, ch, 3, padding=1))
            c_in = ch

    def forward(self, feats):
        x = feats[:, None]
        for i in range(2):
            for j in (1, 2):
                x = torch.relu(conv_in_dtype(getattr(self, f"conv{i}_{j}"), x))
            x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], x.shape[1], -1)


class RNNEncoder(nn.Module):
    """[B, T, F] features -> ([B, T', H], [B] lengths), pads zeroed;
    ``use_vgg`` is the ``vgg_rnn`` choice (VGG2L under ``conv2d``)."""

    def __init__(self, cfg: ConformerConfig, input_size: int, use_vgg: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.vgg_front = use_vgg and cfg.input_layer == "conv2d"
        hidden = self.output_size = cfg.output_size
        with torch.device(resolve_device(device)):
            if self.vgg_front:
                self.vgg = VGG2L()
                width = (input_size // 4) * 128
            else:
                self.embed = Dense(input_size, hidden)
                width = hidden
            for i in range(cfg.num_blocks):
                for j in (2 * i, 2 * i + 1):
                    self.add_module(f"OptimizedLSTMCell_{j}", LSTMCell(hidden, width))
                self.add_module(f"proj{i}", Dense(2 * hidden, hidden))
                width = hidden

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.vgg_front:
            x = self.vgg(feats)
            out_lengths = torch.div(feats_lengths, 4, rounding_mode="floor")
        else:
            x, out_lengths = self.embed(feats), feats_lengths
        dtype = x.dtype
        for i in range(self.cfg.num_blocks):
            xf = at_least_f32(x)  # the cells' float32, as flax promotes them
            fwd = lstm_stack([getattr(self, f"OptimizedLSTMCell_{2 * i}")], xf)
            bwd = lstm_stack([getattr(self, f"OptimizedLSTMCell_{2 * i + 1}")], xf.flip(1)).flip(1)
            x = torch.tanh(getattr(self, f"proj{i}")(torch.cat([fwd, bwd], dim=-1), dtype))
        valid = make_valid_mask(out_lengths, x.shape[1])
        return x.masked_fill(~valid[..., None], 0.0), out_lengths
