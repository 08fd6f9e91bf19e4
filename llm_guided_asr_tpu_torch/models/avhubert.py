"""AV-HuBERT audio-visual encoder (counterpart of llm_guided_asr_tpu/models/avhubert.py;
espnet2/asr/encoder/avhubert_encoder.py).

- :class:`ResEncoder`: the video frontend.  A 3-D stem over (T, H, W)
  (kernel (5, 7, 7), stride (1, 2, 2)), GroupNorm and ReLU, a (1, 3, 3)
  max pool at stride (1, 2, 2), then a ResNet-18 of :class:`BasicBlock2D`
  per frame with time folded into the batch, and the spatial mean: one
  vector a frame.
- :class:`AVHubertModel`: the audio projection (``audio_proj``) and the
  video one (``video_proj`` over ``video_resnet``), fused by concatenation
  or sum (``fuse``, with modality dropout in training mode), LayerNorm,
  ``post_proj``, the grouped-conv positional embedding
  (:class:`ConvPositionalEmbedding`) and pre-norm Transformer layers.
- :class:`AVHubertEncoder`: the encoder registry's wrapper, audio-only at
  the task level; the audio-visual path is its ``video`` argument.

flax's convolutions are channels-last with SAME padding; the port runs
channels-first and pads explicitly as flax does: SAME at stride 2 puts the
odd pixel of padding after (an 88-pixel frame pads (2, 3) for the 7-wide
stem, a 44-pixel one (0, 1) for the pool and a 22-pixel one (0, 1) for a
3-wide conv), and the max pool pads with -inf.  flax's GroupNorm takes eps
1e-6; the GELU of the positional embedding is the tanh form; every other
LayerNorm is the 1e-5 helper.  No hand-written kernel runs here: the
convolutions, GEMMs and the attention are PyTorch's.

Compute dtype (JAX's ``dtype``): :class:`AVHubertEncoder` casts the audio
features and the video to it (JAX :212, :218), and every conv, Dense and
LayerNorm computes in it, the GroupNorms and LayerNorms with float32
statistics; the modality-dropout mask and the zeros of a missing modality
are in it too (:182-197).  The port turns TF32 off for parity
(utils/device.py), which reaches float32 products alone: in bfloat16 the
convolutions and GEMMs take bfloat16 operands on the tensor cores with
float32 accumulation whatever that flag says.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import gelu_tanh
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    GroupNorm,
    LayerNorm,
    MultiHeadedAttention,
    PositionwiseFeedForward,
    add_and_norm,
    conv_in_dtype,
    register_compute_dtype,
    to_compute,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG

GN_EPS = 1e-6  # flax GroupNorm's epsilon


@dataclasses.dataclass(frozen=True)
class AVHubertConfig:
    encoder_embed_dim: int = 768
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    encoder_ffn_embed_dim: int = 3072
    dropout: float = 0.1
    audio_feat_dim: int = 104  # stacked filterbank features per video frame
    resnet_channels: Tuple[int, ...] = (64, 128, 256, 512)
    resnet_blocks_per_stage: int = 2
    frontend_channels: int = 64  # the 3-D stem's output
    modality_fuse: str = "concat"  # concat | add
    modality_dropout: float = 0.0  # P(drop one modality) in training mode
    audio_dropout: float = 0.5  # P(the dropped modality is audio | dropping)
    conv_pos: int = 128  # the positional conv's kernel
    conv_pos_groups: int = 16
    audio_only: bool = False


def same_pad(sizes: Sequence[int], kernel: Sequence[int],
             strides: Sequence[int]) -> Tuple[int, ...]:
    """flax/lax SAME padding of the trailing ``len(sizes)`` axes as an
    ``F.pad`` tuple (last axis first): out = ceil(n / s), the odd pixel
    after."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


class SameConv(nn.Module):
    """A bias-free flax ``nn.Conv`` with SAME padding, channels first:
    2-D ([N, C, H, W]) or 3-D ([N, C, T, H, W]) by the kernel's rank, in
    its input's type."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, ...],
                 strides: Optional[Tuple[int, ...]] = None):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides or (1,) * len(kernel))
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, same_pad(x.shape[2:], self.kernel, self.strides))
        conv = F.conv3d if len(self.kernel) == 3 else F.conv2d
        return conv(x, self.weight.to(x.dtype), stride=self.strides)


def group_norm(channels: int) -> GroupNorm:
    return GroupNorm(min(32, channels), channels, eps=GN_EPS)


class BasicBlock2D(nn.Module):
    """ResNet-18 basic block with GroupNorm in place of BatchNorm: conv1
    (3x3, ``stride``), gn1, ReLU, conv2, gn2, plus the input or, when the
    stride or the width changes, ``down`` (1x1, ``stride``) and
    ``gn_down``; ReLU."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv(cin, planes, (3, 3), (stride, stride))
        self.gn1 = group_norm(planes)
        self.conv2 = SameConv(planes, planes, (3, 3))
        self.gn2 = group_norm(planes)
        self.has_down = stride != 1 or cin != planes
        if self.has_down:
            self.down = SameConv(cin, planes, (1, 1), (stride, stride))
            self.gn_down = group_norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.gn2(self.conv2(torch.relu(self.gn1(self.conv1(x)))))
        residual = self.gn_down(self.down(x)) if self.has_down else x
        return torch.relu(h + residual)


class ResEncoder(nn.Module):
    """[B, T, H, W] grayscale lip crops -> [B, T, resnet_channels[-1]]."""

    def __init__(self, cfg: AVHubertConfig):
        super().__init__()
        self.cfg = cfg
        self.stem = SameConv(1, cfg.frontend_channels, (5, 7, 7), (1, 2, 2))
        self.stem_gn = group_norm(cfg.frontend_channels)
        cin = cfg.frontend_channels
        for si, planes in enumerate(cfg.resnet_channels):
            for bi in range(cfg.resnet_blocks_per_stage):
                stride = 2 if (si > 0 and bi == 0) else 1
                setattr(self, f"s{si}b{bi}", BasicBlock2D(cin, planes, stride))
                cin = planes

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = torch.relu(self.stem_gn(self.stem(video[:, None])))  # [B, C, T, H, W]
        x = F.pad(x, same_pad(x.shape[2:], (1, 3, 3), (1, 2, 2)), value=float("-inf"))
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2))
        b, c, t, h, w = x.shape
        x = x.transpose(1, 2).reshape(b * t, c, h, w)  # time folded into the batch
        for si in range(len(cfg.resnet_channels)):
            for bi in range(cfg.resnet_blocks_per_stage):
                x = getattr(self, f"s{si}b{bi}")(x)
        return x.mean(dim=(2, 3)).reshape(b, t, -1)


class ConvPositionalEmbedding(nn.Module):
    """x + GELU(grouped conv of x over time): ``conv`` of ``kernel`` taps
    and ``groups`` groups with SAME padding (63 before, 64 after at 128)."""

    def __init__(self, dim: int, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv1d(dim, dim, kernel, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.pad(x.transpose(1, 2), same_pad(x.shape[1:2], (self.kernel,), (1,)))
        return x + gelu_tanh(conv_in_dtype(self.conv, h).transpose(1, 2))


class _TrunkLayer(nn.Module):
    """Pre-norm layer: x + attn(ln1(x)), then x + ffn(ln2(x)); ReLU FFN,
    the attention probabilities and the FFN's hidden units dropped at
    ``dropout``."""

    def __init__(self, cfg: AVHubertConfig):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.ln1 = LayerNorm(d)
        self.attn = MultiHeadedAttention(d, cfg.encoder_attention_heads, cfg.dropout)
        self.ln2 = LayerNorm(d)
        self.ffn = PositionwiseFeedForward(d, cfg.encoder_ffn_embed_dim, dropout_rate=cfg.dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        h = self.ln1(x)
        x, h = add_and_norm(x, self.attn(h, h, h, mask, rng=rng), self.ln2)
        return x + self.ffn(h, rng)


class AVHubertModel(nn.Module):
    """Fusion and the Transformer trunk (avhubert_encoder.py:593)."""

    def __init__(self, cfg: AVHubertConfig, audio_dim: int):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        self.audio_proj = Dense(audio_dim, d)
        if not cfg.audio_only:
            self.video_resnet = ResEncoder(cfg)
            self.video_proj = Dense(cfg.resnet_channels[-1], d)
        fused = 2 * d if cfg.modality_fuse == "concat" else d
        self.fuse_norm = LayerNorm(fused)
        self.post_proj = Dense(fused, d)
        self.pos_conv = ConvPositionalEmbedding(d, cfg.conv_pos, cfg.conv_pos_groups)
        for i in range(cfg.encoder_layers):
            setattr(self, f"layer_{i}", _TrunkLayer(cfg))
        self.final_norm = LayerNorm(d)

    def fuse(self, audio_feats: Optional[torch.Tensor], video_feats: Optional[torch.Tensor],
             rng: Optional[StepRNG] = None) -> torch.Tensor:
        """modality_fusion (:747) and, in training mode, modality dropout
        (:233-247): with probability ``modality_dropout`` one half of the
        concatenated features is zeroed for the whole batch, the audio half
        with probability ``audio_dropout``.  The two uniforms come from the
        step's CPU generator (``rng.host``)."""
        cfg = self.cfg
        d = cfg.encoder_embed_dim
        ref = audio_feats if audio_feats is not None else video_feats
        if audio_feats is None:
            audio_feats = ref.new_zeros(ref.shape[:2] + (d,))
        if video_feats is None:
            video_feats = ref.new_zeros(ref.shape[:2] + (d,))
        if cfg.modality_fuse == "concat":
            fused = torch.cat([audio_feats, video_feats], dim=-1)
        elif cfg.modality_fuse == "add":
            fused = audio_feats + video_feats
        else:
            raise ValueError(f"unknown fusion {cfg.modality_fuse!r}")
        if (self.training and cfg.modality_dropout > 0 and cfg.modality_fuse == "concat"
                and rng is not None):
            r_drop, r_which = torch.rand(2, generator=rng.host).tolist()
            if r_drop < cfg.modality_dropout:
                keep = torch.ones(2 * d, dtype=fused.dtype, device=fused.device)
                half = slice(0, d) if r_which < cfg.audio_dropout else slice(d, 2 * d)
                keep[half] = 0.0
                fused = fused * keep
        return fused

    def forward(self, audio: Optional[torch.Tensor], lengths: torch.Tensor,
                video: Optional[torch.Tensor] = None, rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio [B, T, F] features and/or video [B, T, H, W] -> ([B, T, D], lengths)."""
        audio_feats = self.audio_proj(audio) if audio is not None else None
        video_feats = None
        if video is not None and not self.cfg.audio_only:
            video_feats = self.video_proj(self.video_resnet(video))
        x = self.pos_conv(self.post_proj(self.fuse_norm(self.fuse(audio_feats, video_feats, rng))))
        valid = make_valid_mask(lengths, x.shape[1])
        x = x.masked_fill(~valid[..., None], 0.0)
        for i in range(self.cfg.encoder_layers):
            x = getattr(self, f"layer_{i}")(x, valid[:, None, :], rng)
        return self.final_norm(x), lengths


class AVHubertEncoder(nn.Module):
    """The registry's encoder: (feats, lengths, rng) -> (``out_proj`` of the
    trunk's output, lengths); no subsampling.  Audio-only at the task level
    (the reference's ``audio_only``); ``video`` [B, T, H, W] takes the
    audio-visual path of a model built with ``audio_only=False``.  Both
    inputs are cast to ``dtype``, the compute dtype."""

    def __init__(self, cfg: AVHubertConfig, output_size: int, input_size: int,
                 device: Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.output_size = output_size
        with torch.device(resolve_device(device)):
            register_compute_dtype(self, dtype)
            self.trunk = AVHubertModel(cfg, input_size)
            self.out_proj = Dense(cfg.encoder_embed_dim, output_size)

    def forward(self, feats: Optional[torch.Tensor], lengths: torch.Tensor,
                rng: Optional[StepRNG] = None, video: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = None if feats is None else to_compute(self, feats)
        video = None if video is None else to_compute(self, video)
        x, out_lens = self.trunk(feats, lengths, video, rng)
        return self.out_proj(x), out_lens
