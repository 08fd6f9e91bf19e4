"""Conformer and Transformer encoders (counterpart of llm_guided_asr_tpu/models/conformer.py).

Input layer (``conv2d`` x4 subsampling, ``linear`` or ``none``) ->
positional encoding -> N blocks of [0.5*FFN (macaron) -> MHSA -> conv
module -> FFN -> LN].  Under ``none`` the blocks take the features' width,
as flax infers it; every encoder reports the width it gives in
``output_size``.  The self-attention
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
    Dense,
    FlashSelfAttention,
    LayerNorm,
    MultiHeadedAttention,
    PositionalEncoding,
    PositionwiseFeedForward,
    RelPositionalEncoding,
    RelPositionMultiHeadedAttention,
    TransformerEncoderLayer,
    at_least_f32,
    sub4_lengths,
)
from llm_guided_asr_tpu_torch.ops.depthwise_conv import depthwise_conv1d
from llm_guided_asr_tpu_torch.ops.masked_bn import masked_batch_norm
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """The fields of the JAX ConformerConfig that the port's encoders read."""

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
    # the MultiConvformer only: the cgMLP's depthwise kernel sizes
    multicgmlp_kernel_sizes: Tuple[int, ...] = (7, 15, 23, 31)
    # the S4 encoder only (models/state_spaces.py): the layer cycle of a
    # block group, the SSM state size, the norm and its position, the
    # residual function, the pooling between groups, the FFN expansion,
    # the anticausal kernel and stochastic depth
    ss_layers: Tuple[str, ...] = ("s4", "ff")  # s4 | s4d | ff | mha
    ss_d_state: int = 64
    ss_prenorm: bool = True
    ss_norm: str = "layer"  # layer | batch | none
    ss_residual: str = "residual"  # residual | affine | feedforward | highway | decay
    ss_pool: str = ""  # '' (none) | sample | avg | linear
    ss_pool_stride: int = 1
    ss_ff_expand: int = 2
    ss_bidirectional: bool = True
    ss_drop_path: float = 0.0
    # the wav2vec2_hf/hubert_hf/whisper_hf encoders only: the local HF directory
    model_name_or_path: Optional[str] = None


def encoder_conf_values(conf: dict) -> dict:
    """The sequence fields of an ``encoder_conf`` as the config holds them:
    tuples, and ``ss_layers`` also from one comma-separated string (as the
    JAX ConformerConfig.from_dict reads it)."""
    conf = dict(conf)
    for k in ("interctc_layer_idx", "multicgmlp_kernel_sizes"):
        if conf.get(k) is not None:
            conf[k] = tuple(conf[k])
    ss = conf.get("ss_layers")
    if ss is not None:
        conf["ss_layers"] = tuple(x.strip() for x in (ss.split(",") if isinstance(ss, str) else ss))
    return conf


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default: the tanh approximation, not the exact erf GELU."""
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"swish": F.silu, "relu": torch.relu, "gelu": gelu_tanh, "hardtanh": F.hardtanh}
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
        self.pointwise_conv1 = Dense(d, 2 * d)
        self.depthwise_conv = DepthwiseConv1d(d, kernel_size)
        self.norm = MaskedBatchNorm(d) if norm_type == "batch_norm" else LayerNorm(d)
        self.pointwise_conv2 = Dense(d, d)
        self.activation = activation
        self.mask_pads = mask_pads

    def forward(self, x, valid):
        h = self.pointwise_conv1(x)
        a, gate = h.chunk(2, dim=-1)
        # flax nn.glu: first half x sigmoid(second), in float32, rounded once
        h = (at_least_f32(a) * torch.sigmoid(at_least_f32(gate))).to(a.dtype)
        if self.mask_pads:
            h = h.masked_fill(~valid[..., None], 0.0)
        h = self.depthwise_conv(h.contiguous())
        h = self.norm(h, valid) if isinstance(self.norm, MaskedBatchNorm) else self.norm(h)
        h = self.activation(h)
        return self.pointwise_conv2(h)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, d: int):
        super().__init__()
        attn_type = _ATTENTIONS.get(cfg.selfattention_layer_type)
        if attn_type is None:
            raise ValueError(f"selfattention_layer_type={cfg.selfattention_layer_type!r}; "
                             f"expected one of {sorted(_ATTENTIONS)}")
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


INPUT_LAYERS = ("conv2d", "linear", "none")


def input_layer(kind: str, input_size: int, output_size: int) -> Tuple[Optional[nn.Module], int]:
    """The encoder's input layer (``embed``) and the width it gives the
    blocks: ``conv2d`` x4 subsampling or ``linear`` (one Dense) to
    ``output_size``; ``none`` keeps the features' width."""
    if kind == "conv2d":
        return Conv2dSubsampling(input_size, output_size), output_size
    if kind == "linear":
        return Dense(input_size, output_size), output_size
    if kind == "none":
        return None, input_size
    raise ValueError(f"input_layer={kind!r}; expected one of {INPUT_LAYERS}")


def refuse_no_input_layer(cfg: ConformerConfig) -> None:
    """The encoders whose JAX module knows only ``conv2d`` and ``linear``."""
    if cfg.input_layer == "none":
        raise ValueError("input_layer='none'; this encoder takes conv2d or linear")


def embed_features(encoder: nn.Module, feats: torch.Tensor, feats_lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encoder.embed`` over the features and the lengths it gives."""
    if encoder.embed is None:
        return feats, feats_lengths
    x = encoder.embed(feats)
    if encoder.cfg.input_layer == "conv2d":
        return x, sub4_lengths(feats_lengths, feats.shape[1])
    return x, feats_lengths


class ConformerEncoder(nn.Module):
    """[B, T, F] features -> ([B, T', D] encoded, [B] lengths)."""

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.pos_enc_layer_type not in ("rel_pos", "abs_pos"):
            raise ValueError(f"pos_enc_layer_type={cfg.pos_enc_layer_type!r}")
        if cfg.selfattention_layer_type == "rel_selfattn" and cfg.pos_enc_layer_type != "rel_pos":
            raise ValueError("rel_selfattn needs pos_enc_layer_type='rel_pos'")
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
                setattr(self, f"block_{i}", ConformerBlock(cfg, d))
            if cfg.normalize_before:
                self.after_norm = LayerNorm(d)

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, lengths, _ = self.forward_with_intermediates(feats, feats_lengths, rng)
        return x, lengths

    def forward_with_intermediates(self, feats, feats_lengths, rng: Optional[StepRNG] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        """As ``forward``, plus the outputs of the ``interctc_layer_idx``
        blocks (1-based), pad frames zeroed (the intermediate-CTC taps)."""
        x, out_lengths = embed_features(self, feats, feats_lengths)
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


class TransformerEncoder(nn.Module):
    """Plain transformer encoder (conformer.py TransformerEncoder; espnet2
    transformer_encoder.py): input layer -> abs positional encoding -> N
    pre-norm TransformerEncoderLayers (dense MHA, relu FFN) -> ``after_norm``
    when ``normalize_before``.  With ``attention_window`` set, the
    attention also masks the keys farther than that many frames.  It runs
    no hand-written kernel."""

    attention_window: Optional[int] = None

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.embed, d = input_layer(cfg.input_layer, input_size, cfg.output_size)
            self.output_size = d
            self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
            for i in range(cfg.num_blocks):
                setattr(self, f"block_{i}", TransformerEncoderLayer(
                    d, cfg.attention_heads, cfg.linear_units, cfg.dropout_rate,
                    cfg.attention_dropout_rate))
            if cfg.normalize_before:
                self.after_norm = LayerNorm(d)

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, out_lengths = embed_features(self, feats, feats_lengths)
        x = self.pos_enc(x, rng=rng)
        valid = make_valid_mask(out_lengths, x.shape[1])
        mask = valid[:, None, :]
        if self.attention_window is not None:
            pos = torch.arange(x.shape[1], device=x.device)
            mask = mask & ((pos[:, None] - pos[None, :]).abs() <= self.attention_window)[None]
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, mask, rng)
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x.masked_fill(~valid[..., None], 0.0), out_lengths


class LongformerEncoder(TransformerEncoder):
    """Sliding-window self-attention encoder (conformer.py LongformerEncoder;
    espnet2 longformer_encoder.py): the input layer (``conv2d`` or
    ``linear``), abs positions, then N pre-norm TransformerEncoderLayers
    whose dense attention masks the keys farther than ``attention_window``
    frames (fixed at 64 after subsampling, as in JAX) besides the pads,
    ``after_norm`` when ``normalize_before``.  It runs no hand-written
    kernel."""

    attention_window = 64

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        refuse_no_input_layer(cfg)
        super().__init__(cfg, input_size, device=device)


class SameConv1d(nn.Module):
    """flax ``nn.Conv(C_out, (K,), strides=(s,), padding="SAME")`` over
    [B, T, C_in]: weight [C_out, C_in, K] (Conv1d's layout), bias.  SAME
    pads explicitly as flax does: ceil(T/s) outputs, the total padding
    split with the odd frame on the right (at stride 2 and K = 3: (0, 1)
    for an even T, (1, 1) for an odd one).  In its input's type (flax's
    ``dtype``)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        t, k, s = x.shape[1], self.weight.shape[2], self.stride
        total = max((-(-t // s) - 1) * s + k - t, 0)
        xp = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        return F.conv1d(xp, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=s).transpose(1, 2)


class WhisperStyleEncoder(nn.Module):
    """Whisper-architecture encoder (conformer.py WhisperStyleEncoder):
    ``conv1`` (K = 3) and GELU, ``conv2`` (K = 3, stride 2) and GELU (the
    tanh form) over the features, lengths (T + 1) // 2, sinusoidal
    positions, N pre-norm TransformerEncoderLayers, ``after_norm``.  The
    input layer is its own (``input_layer`` is not read).  It runs no
    hand-written kernel."""

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.output_size = d = cfg.output_size
        with torch.device(resolve_device(device)):
            self.conv1 = SameConv1d(input_size, d, 3)
            self.conv2 = SameConv1d(d, d, 3, stride=2)
            self.pos_enc = PositionalEncoding(cfg.positional_dropout_rate)
            for i in range(cfg.num_blocks):
                setattr(self, f"block_{i}", TransformerEncoderLayer(
                    d, cfg.attention_heads, cfg.linear_units, cfg.dropout_rate,
                    cfg.attention_dropout_rate))
            self.after_norm = LayerNorm(d)

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = gelu_tanh(self.conv2(gelu_tanh(self.conv1(feats))))
        out_lengths = torch.div(feats_lengths + 1, 2, rounding_mode="floor")
        x = self.pos_enc(x, rng=rng)
        valid = make_valid_mask(out_lengths, x.shape[1])
        for i in range(self.cfg.num_blocks):
            x = getattr(self, f"block_{i}")(x, valid[:, None, :], rng)
        return self.after_norm(x).masked_fill(~valid[..., None], 0.0), out_lengths


def make_encoder(encoder_type: str, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """Encoder registry: the Conformer, the Transformer, Longformer and
    Whisper-style encoders here, the E-Branchformer and Branchformer of
    models/branchformer.py, the contextual-block (streaming) Conformer of
    models/streaming.py, the MultiConvformer and (VGG-)RNN encoders of
    models/extra_encoders.py, the audio-only AV-HuBERT of models/avhubert.py,
    the S4 encoder of models/state_spaces.py and the pretrained ``wav2vec2_hf``/``hubert_hf``/``whisper_hf`` encoders of
    models/ssl_encoders.py (JAX models/conformer.py:385-406).

    Every encoder computes in its input's type; ``dtype`` (the model's
    compute dtype) reaches those that cast an input of their own, as the
    JAX modules with ``dtype`` do: the streaming encoder's chunk features,
    AV-HuBERT's audio and video, and the pretrained trunks' waveform or
    frames."""
    if encoder_type == "conformer":
        return ConformerEncoder(cfg, input_size, device=device)
    if encoder_type == "transformer":
        return TransformerEncoder(cfg, input_size, device=device)
    if encoder_type == "longformer":
        return LongformerEncoder(cfg, input_size, device=device)
    if encoder_type == "whisper_style":
        return WhisperStyleEncoder(cfg, input_size, device=device)
    if encoder_type in ("e_branchformer", "branchformer"):
        from llm_guided_asr_tpu_torch.models.branchformer import (
            BranchformerEncoder,
            EBranchformerEncoder,
        )

        cls = EBranchformerEncoder if encoder_type == "e_branchformer" else BranchformerEncoder
        return cls(cfg, input_size, device=device)
    if encoder_type == "contextual_block_conformer":
        from llm_guided_asr_tpu_torch.models.streaming import ContextualBlockConformerEncoder

        return ContextualBlockConformerEncoder(cfg, input_size, block_size=cfg.block_size,
                                               device=device, dtype=dtype)
    if encoder_type == "multiconvformer":
        from llm_guided_asr_tpu_torch.models.extra_encoders import MultiConvformerEncoder

        return MultiConvformerEncoder(cfg, input_size, device=device)
    if encoder_type in ("rnn", "vgg_rnn"):
        from llm_guided_asr_tpu_torch.models.extra_encoders import RNNEncoder

        return RNNEncoder(cfg, input_size, use_vgg=encoder_type == "vgg_rnn", device=device)
    if encoder_type == "avhubert":
        # audio-only at the task level (JAX models/conformer.py:365-378);
        # the audio-visual path is the encoder's ``video`` argument
        from llm_guided_asr_tpu_torch.models.avhubert import AVHubertConfig, AVHubertEncoder

        av_cfg = AVHubertConfig(encoder_embed_dim=cfg.output_size, encoder_layers=cfg.num_blocks,
                                encoder_attention_heads=cfg.attention_heads,
                                encoder_ffn_embed_dim=cfg.linear_units,
                                dropout=cfg.dropout_rate, audio_only=True)
        return AVHubertEncoder(av_cfg, cfg.output_size, input_size, device=device, dtype=dtype)
    if encoder_type == "s4":
        from llm_guided_asr_tpu_torch.models.state_spaces import S4Encoder

        return S4Encoder(cfg, input_size, device=device)
    if encoder_type in ("wav2vec2_hf", "hubert_hf", "whisper_hf"):
        # the trunk's widths come from the local directory's config.json;
        # tasks/asr.py loads its weights (init_model_variables)
        from llm_guided_asr_tpu_torch.models.hf_checkpoint import read_hf_config
        from llm_guided_asr_tpu_torch.models.ssl_encoders import SSLEncoderWrapper, ssl_config

        if not cfg.model_name_or_path:
            raise ValueError(f"{encoder_type} needs encoder_conf.model_name_or_path")
        kind = encoder_type[: -len("_hf")]
        return SSLEncoderWrapper(kind, ssl_config(kind, read_hf_config(cfg.model_name_or_path)),
                                 cfg.output_size, device=device, dtype=dtype)
    raise NotImplementedError(f"encoder type {encoder_type!r} is not ported yet")
