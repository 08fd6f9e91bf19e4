"""Sinc pre-encoder and length-adaptor post-encoder (counterpart of
llm_guided_asr_tpu/models/preencoder.py).

:func:`sliding_window` frames the raw waveform (``frontend_conf.type:
sliding_window``, espnet2/asr/frontend/windowing.py), and
:class:`LightweightSincConvs` (``preencoder: sinc``, espnet2/asr/preencoder/
sinc.py) turns each frame into one vector: learned band-pass filters whose
kernel is rebuilt from two band edges per filter at every call, log
compression, per-channel batch norm and five grouped conv blocks.
:class:`LengthAdaptorPostEncoder` (``postencoder: length_adaptor``) halves
the encoder's frame rate once per layer with a stride-2 conv and ReLU.

Module names follow the flax modules (``filters.f``, ``bn0``, ``dconv_1``,
``adaptor_0`` ...), so convert.params_from_jax maps the JAX tree onto them;
a grouped conv of one input channel per group keeps flax's [K, C_out]
layout, as the port's depthwise convolutions do.  No hand-written kernel
runs here.

Compute dtype: the frames' (the model casts them).  The sinc kernel is
rebuilt from the band edges in float32 and cast to it (JAX :99-101); the
log compression, the grouped convs, the pools and the activations compute
in it; the batch norms take float32 statistics (and running buffers) and
normalize in float32 before casting back, as JAX's ``_ChannelBN`` does
(:117-131).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    at_least_f32,
    conv_in_dtype,
)
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


def sliding_window(speech: torch.Tensor, speech_lengths: torch.Tensor, win_length: int = 400,
                   hop_length: int = 160) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N] -> ([B, T, win_length] raw frames, lengths); T = (N - win) //
    hop + 1 (at least 1), frames past the end read the last sample."""
    n = speech.shape[1]
    t = max((n - win_length) // hop_length + 1, 1)
    idx = (torch.arange(t, device=speech.device)[:, None] * hop_length
           + torch.arange(win_length, device=speech.device)[None, :])
    frames = speech[:, torch.clamp(idx, 0, n - 1)]
    lengths = torch.clamp(torch.div(speech_lengths - win_length, hop_length,
                                    rounding_mode="floor") + 1, min=1)
    return frames, lengths


def mel_filter_bank(out_channels: int, fs: float) -> torch.Tensor:
    """Mel-spaced (f_min, f_max) band edges normalised by fs, [C, 2]
    (sinc_conv.py MelScale.bank)."""

    def hz2mel(f):
        return 1125.0 * math.log(f / 700.0 + 1.0)

    def mel2hz(m):
        return 700.0 * (math.exp(m / 1125.0) - 1.0)

    edges = [mel2hz(hz2mel(30.0) + i * (hz2mel(fs / 2.0) - hz2mel(30.0)) / (out_channels + 1))
             for i in range(out_channels + 2)]
    bank = [(edges[i], edges[i + 2]) for i in range(out_channels)]
    return torch.tensor(bank, dtype=torch.float32) / fs


class SincConv1d(nn.Module):
    """Parametric band-pass conv (sinc_conv.py SincConv): per filter the
    band edges ``f`` [C, 2]; the kernel
    k[n] = (sin(2 pi f_max n) - sin(2 pi f_min n)) / (n pi) * w[n], with a
    Hamming window w over the half kernel, mirrored about its centre."""

    def __init__(self, out_channels: int = 128, kernel_size: int = 101, fs: float = 16000.0):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("the sinc kernel must be odd")
        self.out_channels, self.kernel_size, self.fs = out_channels, kernel_size, fs
        self.f = nn.Parameter(mel_filter_bank(out_channels, fs))

    def reset_jax_init(self):
        self.f.copy_(mel_filter_bank(self.out_channels, self.fs))

    def kernel(self) -> torch.Tensor:
        """[C, K]."""
        n = self.kernel_size // 2
        lin = torch.linspace(1, n, n, device=self.f.device)
        xs = 2 * math.pi * lin
        window = 0.54 - 0.46 * torch.cos(2.0 * math.pi * torch.flip(lin, (0,)) / (2 * n + 1))
        f_min = torch.abs(self.f[:, 0])
        f_max = f_min + torch.abs(self.f[:, 1] - self.f[:, 0])
        right = (torch.sin(f_max[:, None] * xs) - torch.sin(f_min[:, None] * xs)) / (
            0.5 * xs) * window
        center = (2 * f_max - 2 * f_min)[:, None]
        return torch.cat([torch.flip(right, (1,)), center, right], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B*, D] -> [B*, C, D - K + 1] (VALID), in x's type."""
        return F.conv1d(x[:, None, :], self.kernel().to(x.dtype)[:, None, :])


class ChannelBatchNorm(nn.Module):
    """Per-channel batch norm over every (row, position) of [N, C, D]
    (``_ChannelBN``): batch statistics in training mode (the biased
    variance E[x^2] - E[x]^2), which update the running ones at momentum
    0.9; the running ones in eval mode.  Statistics and the normalization
    in float32 (at least), the output in the input's type."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def reset_jax_init(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        if self.training:
            flat = xf.transpose(0, 1).reshape(x.shape[1], -1)
            mean = flat.mean(dim=1)
            var = torch.clamp((flat * flat).mean(dim=1) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean.detach())
                self.running_var.mul_(m).add_((1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None]) * inv[:, None] * self.weight[:, None] + self.bias[:, None]
        return y if y.dtype == x.dtype else y.to(x.dtype)


class GroupedConv1d(nn.Module):
    """A VALID conv with one input channel per group (flax
    ``feature_group_count`` = C_in), weight in flax's [K, C_out] layout."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1):
        super().__init__()
        self.c_in, self.stride = c_in, stride
        self.weight = nn.Parameter(torch.empty(k, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, C_in, D] -> [N, C_out, D'], in x's type."""
        return F.conv1d(x, self.weight.to(x.dtype).t()[:, None, :], self.bias.to(x.dtype),
                        stride=self.stride, groups=self.c_in)


@dataclasses.dataclass(frozen=True)
class SincPreencoderConfig:
    fs: float = 16000.0
    out_channels: int = 256
    sinc_channels: int = 128
    sinc_kernel: int = 101
    activation_type: str = "leakyrelu"  # leakyrelu | relu
    dropout_rate: float = 0.15


# (name, kernel, stride, avg-pool after, output channels: sinc or out)
_DCONV_BLOCKS = ((1, 25, 2, True, "sinc"), (2, 9, 1, False, "out"), (3, 9, 1, False, "out"),
                 (4, 9, 1, False, "out"), (5, 7, 1, False, "out"))


class LightweightSincConvs(nn.Module):
    """Sinc pre-encoder body (sinc.py LightweightSincConvs): [B, T, D] raw
    frames -> [B, T, out_channels]."""

    def __init__(self, cfg: SincPreencoderConfig):
        super().__init__()
        self.cfg = cfg
        self.filters = SincConv1d(cfg.sinc_channels, cfg.sinc_kernel, cfg.fs)
        self.bn0 = ChannelBatchNorm(cfg.sinc_channels)
        c = cfg.sinc_channels
        for i, k, s, _, kind in _DCONV_BLOCKS:
            out = cfg.sinc_channels if kind == "sinc" else cfg.out_channels
            setattr(self, f"dconv_{i}", GroupedConv1d(c, out, k, s))
            setattr(self, f"bn_{i}", ChannelBatchNorm(out))
            c = out
        self.output_size = cfg.out_channels

    def _act(self, x):
        return F.relu(x) if self.cfg.activation_type == "relu" else F.leaky_relu(x, 0.01)

    def forward(self, frames: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        b, t, d = frames.shape
        x = self.filters(frames.reshape(b * t, d))
        x = self.bn0(torch.log(torch.abs(x) + 1.0))
        x = F.avg_pool1d(x, 2, 2)
        for i, _, _, pool, _ in _DCONV_BLOCKS:
            x = getattr(self, f"bn_{i}")(self._act(getattr(self, f"dconv_{i}")(x)))
            if pool:
                x = F.avg_pool1d(x, 2, 2)
            x = dropout(x, active_rate(self, 0.1 if i == 1 else self.cfg.dropout_rate), rng)
        return x.mean(dim=2).reshape(b, t, -1)


@dataclasses.dataclass(frozen=True)
class LengthAdaptorConfig:
    n_layers: int = 1
    input_layer: Optional[str] = None  # None | linear
    output_size: Optional[int] = None
    dropout_rate: float = 0.1

    @classmethod
    def from_dict(cls, d: dict) -> "LengthAdaptorConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        if "length_adaptor_n_layers" in d:
            d["n_layers"] = d.pop("length_adaptor_n_layers")
        return cls(**{k: v for k, v in d.items() if k in known})


class LengthAdaptorPostEncoder(nn.Module):
    """Stride-2 conv + ReLU per layer after the encoder, lengths halved (at
    least 1); ``input_layer: linear`` first maps to ``output_size`` with a
    Linear, a LayerNorm (flax's epsilon 1e-6) and dropout.  In its input's
    type (the model's compute dtype), as JAX's with ``dtype``."""

    def __init__(self, cfg: LengthAdaptorConfig, d_in: int):
        super().__init__()
        self.cfg = cfg
        d = d_in
        if cfg.input_layer == "linear":
            self.embed = Dense(d_in, cfg.output_size)
            self.embed_ln = LayerNorm(cfg.output_size, eps=1e-6)
            d = cfg.output_size
        for i in range(cfg.n_layers):
            setattr(self, f"adaptor_{i}", nn.Conv1d(d, d, 2, stride=2))
        self.output_size = d

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if cfg.input_layer == "linear":
            x = dropout(self.embed_ln(self.embed(x)), active_rate(self, cfg.dropout_rate), rng)
        x = x.transpose(1, 2)
        for i in range(cfg.n_layers):
            x = F.relu(conv_in_dtype(getattr(self, f"adaptor_{i}"), x))
            lengths = torch.div(lengths, 2, rounding_mode="floor")
        return x.transpose(1, 2), torch.clamp(lengths, min=1)
