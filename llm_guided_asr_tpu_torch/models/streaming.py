"""Streaming encoder: the contextual-block Conformer (counterpart of
llm_guided_asr_tpu/models/streaming.py).

espnet2/asr/encoder/contextual_block_conformer_encoder.py cuts the signal
into fixed blocks of ``block_size`` sub-frames; each layer's
self-attention sees [a carried context vector | the current block] only,
and each block leaves a new context vector for the next one.  Outputs so
depend on past blocks alone, and :meth:`ContextualBlockConformerEncoder.
encode_chunk` encodes new frames incrementally with the carried per-layer
contexts, equal to the offline pass.

The port follows the JAX package's documented deviation from the
reference: the context starts at zero in every layer and becomes the
masked mean of each block's output (a block without a valid frame keeps
the old one), instead of the reference's learned positional context.

The conv module is block-local: its depthwise conv (ops/depthwise_conv.py,
``dwconv1d_fwd`` on the card) sees one block at a time, zero-padded at the
block's edges, with a LayerNorm after it; the blocks run one after the
other, since attention reads the carried context, so a layer launches the
depthwise kernel once a block.

Compute dtype: the features' (the model casts them; :meth:`encode_chunk`
casts its own, as the JAX module's first conv does).  The offline pass's
zero contexts are in it (JAX :183) and each block's context mean divides
by the valid count in it (:107).  A context carried in float32 (the
streaming recognizer's, as JAX's starts as float32 zeros) keeps that type
across blocks, as flax promotes it, and enters the attention in the
compute dtype, where JAX's Dense casts it; its values are the compute
dtype's, so nothing rounds there.  The chunk's positional encoding is the
offline pass's (models/transformer.py PositionalEncoding) at the chunk's
positions, so chunk and offline rows agree bit for bit in either dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import (
    _ACTIVATIONS,
    ConformerConfig,
    ConvolutionModule,
    embed_features,
    input_layer,
)
from llm_guided_asr_tpu_torch.models.transformer import (
    LayerNorm,
    MultiHeadedAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    at_least_f32,
    register_compute_dtype,
    sinusoidal_pos_enc,
    to_compute,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG

PE_MAX_LEN = 5000  # the JAX PositionalEncoding's table; encode_chunk clips to it


class ContextualBlockLayer(nn.Module):
    """One Conformer layer run block by block with a carried context token."""

    def __init__(self, cfg: ConformerConfig, d: int):
        super().__init__()
        act = _ACTIVATIONS[cfg.activation_type]
        self.cfg = cfg
        self.self_attn = MultiHeadedAttention(d, cfg.attention_heads, cfg.attention_dropout_rate)
        if cfg.macaron_style:
            self.feed_forward_macaron = PositionwiseFeedForward(d, cfg.linear_units, act,
                                                                cfg.dropout_rate)
            self.norm_ff_macaron = LayerNorm(d)
        self.feed_forward = PositionwiseFeedForward(d, cfg.linear_units, act, cfg.dropout_rate)
        if cfg.use_cnn_module:
            self.conv_module = ConvolutionModule(d, cfg.cnn_module_kernel, "layer_norm", act,
                                                 mask_pads=True)
            self.norm_conv = LayerNorm(d)
        self.norm_mha = LayerNorm(d)
        self.norm_ff = LayerNorm(d)
        self.norm_final = LayerNorm(d)

    def block_step(self, ctx, x, valid, rng: Optional[StepRNG] = None):
        """ctx [B, D], x [B, S, D], valid [B, S] -> (next context, output)."""
        cfg = self.cfg
        if cfg.macaron_style:
            x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x), rng)
        h = self.norm_mha(x)
        kv = torch.cat([ctx[:, None, :].to(h.dtype), h], dim=1)  # [B, S+1, D]
        kv_valid = torch.cat([torch.ones_like(valid[:, :1]), valid], dim=1)
        x = x + self.self_attn(h, kv, kv, kv_valid[:, None, :], rng=rng)
        if cfg.use_cnn_module:
            x = x + self.conv_module(self.norm_conv(x), valid)
        x = x + (0.5 if cfg.macaron_style else 1.0) * self.feed_forward(self.norm_ff(x), rng)
        x = self.norm_final(x).masked_fill(~valid[..., None], 0.0)
        # the next context: the masked mean of this block's output
        denom = torch.clamp(valid.sum(dim=1, keepdim=True), min=1).to(x.dtype)
        new_ctx = x.sum(dim=1) / denom
        return torch.where(valid.any(dim=1, keepdim=True), new_ctx, ctx), x

    def forward(self, blocks, block_valid, ctx0, rng: Optional[StepRNG] = None):
        """blocks [B, N, S, D], block_valid [B, N, S], ctx0 [B, D] ->
        (blocks out, the last context)."""
        ctx, outs = ctx0, []
        for bi in range(blocks.shape[1]):
            ctx, y = self.block_step(ctx, blocks[:, bi], block_valid[:, bi], rng)
            outs.append(y)
        return torch.stack(outs, dim=1), ctx


class ContextualBlockConformerEncoder(nn.Module):
    """[B, T, F] features -> ([B, T', D], [B] lengths), block-causal.

    The input layer is ``conv2d`` (x4 subsampling), ``linear`` (one Dense)
    or ``none`` (the layers take the features' width), as in JAX; only
    :meth:`encode_chunk` needs ``conv2d``.  It computes in ``dtype``."""

    def __init__(self, cfg: ConformerConfig, input_size: int, block_size: int = 40,
                 device: Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.block_size = block_size
        with torch.device(resolve_device(device)):
            register_compute_dtype(self, dtype)
            self.embed, d = input_layer(cfg.input_layer, input_size, cfg.output_size)
            self.output_size = d
            self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
            for i in range(cfg.num_blocks):
                setattr(self, f"layer_{i}", ContextualBlockLayer(cfg, d))
            if cfg.normalize_before:
                self.after_norm = LayerNorm(d)

    def _layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_blocks)]

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, out_lengths = embed_features(self, feats, feats_lengths)
        x = self.pos_enc(x, rng=rng)
        b, t, d = x.shape
        s = self.block_size
        n = -(-t // s)
        x = torch.nn.functional.pad(x, (0, 0, 0, n * s - t))
        blocks = x.reshape(b, n, s, d)
        bvalid = make_valid_mask(out_lengths, n * s).reshape(b, n, s)
        for layer in self._layers():
            # a fresh zero context per layer: context flows forward within a
            # layer only (layer i's last context would leak future blocks)
            blocks, _ = layer(blocks, bvalid, x.new_zeros(b, d), rng)
        x = blocks.reshape(b, n * s, d)[:, :t]
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x.masked_fill(~make_valid_mask(out_lengths, t)[..., None], 0.0), out_lengths

    def encode_chunk(self, feats: torch.Tensor, ctxs: torch.Tensor, pos_offset: int,
                     n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Incremental encode of m sub-frames (m a multiple of block_size):
        feats [B, 4m + 6, F] must start at input frame 4 * pos_offset, so
        that the subsampling windows tile as in the offline pass (sub-frame
        i reads input frames [4i, 4i + 6]); ctxs [num_blocks, B, D] are the
        carried contexts; the first ``n_valid`` sub-frames are valid.  The
        positions are pos_offset + [0, m), clipped to the 5000-row table
        as the JAX function clips them.  Returns ([B, m, D], new ctxs in
        ctxs' type)."""
        if self.cfg.input_layer != "conv2d":
            raise NotImplementedError("streaming encode_chunk requires conv2d input")
        x = self.embed(to_compute(self, feats))  # [B, m, D]: VALID convs over 4m + 6 frames
        b, m, d = x.shape
        s = self.block_size
        if m % s != 0:
            raise ValueError(f"chunk produces {m} sub-frames, not a multiple of block_size {s}")
        pe = torch.from_numpy(sinusoidal_pos_enc(PE_MAX_LEN, d)).to(x.device)
        pos = torch.clamp(pos_offset + torch.arange(m, device=x.device), 0, PE_MAX_LEN - 1)
        x = (at_least_f32(x) * math.sqrt(d) + pe[pos][None]).to(x.dtype)
        valid = torch.arange(m, device=x.device) < n_valid
        blocks = x.reshape(b, m // s, s, d)
        bvalid = valid.reshape(1, m // s, s).expand(b, m // s, s)
        new_ctxs = []
        for i, layer in enumerate(self._layers()):
            blocks, ctx = layer(blocks, bvalid, ctxs[i])
            new_ctxs.append(ctx)
        x = blocks.reshape(b, m, d)
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x.masked_fill(~valid[None, :, None], 0.0), torch.stack(new_ctxs)
