"""Pretrained wav2vec2 / HuBERT / Whisper encoders (counterpart of
llm_guided_asr_tpu/models/ssl_encoders.py).

Hugging Face's ``Wav2Vec2Model`` / ``HubertModel`` forward in eval mode
(:class:`Wav2Vec2Encoder`, raw 16 kHz audio in) and ``WhisperModel.encoder``
(:class:`WhisperEncoder`, log-mel frames in, time-major [B, T, n_mels] as
in the JAX package), with :class:`SSLEncoderWrapper` adding the Linear to
the ASR model's width.  Module names follow the flax modules
(``feature_extractor.conv_layers_0_conv``, ``layers_3.attention.q_proj``,
``layers_1_self_attn.k_proj`` ...), so convert.params_from_jax maps the JAX
tree onto them; :func:`convert_hf_wav2vec2_state_dict` and
:func:`convert_hf_whisper_encoder_state_dict` map a Hugging Face state dict
(read by models/hf_checkpoint.py) onto them, folding the weight-normed
positional conv of either layout.

Every GELU here is the exact erf form (``jax.nn.gelu(approximate=False)``),
not the tanh form of the port's Conformer.  Attention is plain einsum and
softmax in float32, as in JAX: no hand-written kernel runs here.

Compute dtype (JAX's ``dtype``): each trunk casts its input to its
``dtype`` (the model's compute dtype) and every conv, Dense and LayerNorm
computes in it, the norms' statistics and the attention softmaxes in
float32.  The wav2vec2/HuBERT trunk casts the raw waveform itself to
bfloat16 before the conv feature extractor, as the JAX module does
(ssl_encoders.py:165): its first conv then reads rounded samples, which
a float32 conv in front would not; the port copies the rounding so that
the two packages' bfloat16 trunks see the same input.  Whisper's position
table is cast to the compute dtype before the add (:338).  A LayerNorm
that reads a residual add normalizes the unrounded sum
(models/transformer.py add_and_norm).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.hf_checkpoint import (
    load_hf_state_dict,
    read_hf_config,
    strip_prefix,
)
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    GroupNorm,
    LayerNorm,
    add_and_norm,
    conv_in_dtype,
    register_compute_dtype,
    to_compute,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask


# ---------------------------------------------------------------------------
# wav2vec2 / HuBERT
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class W2VConfig:
    """wav2vec2/HuBERT widths; the defaults are wav2vec2-base's and
    hubert-base's (12 x 768, 12 heads, 3,072 units, 7 x 512 conv channels,
    group norm, post-norm)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # 'group' (base) | 'layer' (large)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False  # False: post-norm (base); True: pre-norm
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf_config(cls, hf: Mapping[str, Any]) -> "W2VConfig":
        """From a parsed ``config.json`` (the defaults of transformers'
        Wav2Vec2Config/HubertConfig for keys it leaves out)."""
        d = cls()
        return cls(
            hidden_size=hf.get("hidden_size", d.hidden_size),
            num_hidden_layers=hf.get("num_hidden_layers", d.num_hidden_layers),
            num_attention_heads=hf.get("num_attention_heads", d.num_attention_heads),
            intermediate_size=hf.get("intermediate_size", d.intermediate_size),
            conv_dim=tuple(hf.get("conv_dim", d.conv_dim)),
            conv_kernel=tuple(hf.get("conv_kernel", d.conv_kernel)),
            conv_stride=tuple(hf.get("conv_stride", d.conv_stride)),
            conv_bias=hf.get("conv_bias", d.conv_bias),
            feat_extract_norm=hf.get("feat_extract_norm", d.feat_extract_norm),
            num_conv_pos_embeddings=hf.get("num_conv_pos_embeddings",
                                           d.num_conv_pos_embeddings),
            num_conv_pos_embedding_groups=hf.get("num_conv_pos_embedding_groups",
                                                 d.num_conv_pos_embedding_groups),
            do_stable_layer_norm=hf.get("do_stable_layer_norm", d.do_stable_layer_norm),
            layer_norm_eps=hf.get("layer_norm_eps", d.layer_norm_eps),
        )

    def out_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        """Frames of the conv feature extractor for ``lengths`` samples."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            lengths = torch.div(lengths - k, s, rounding_mode="floor") + 1
        return torch.clamp(lengths, min=0)


class _W2VFeatureExtractor(nn.Module):
    """VALID strided convs over the waveform, each followed by GELU: group
    norm (groups = channels, statistics over every frame of the padded
    row, pads included, as in JAX) on layer 0 only, or a LayerNorm over
    the channels on every layer; in the input's type."""

    def __init__(self, cfg: W2VConfig):
        super().__init__()
        self.cfg = cfg
        cin = 1
        for i, (c, k, s) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)):
            setattr(self, f"conv_layers_{i}_conv",
                    nn.Conv1d(cin, c, k, stride=s, bias=cfg.conv_bias))
            if cfg.feat_extract_norm == "group" and i == 0:
                setattr(self, "conv_layers_0_layer_norm",
                        GroupNorm(c, c, eps=cfg.layer_norm_eps))
            elif cfg.feat_extract_norm == "layer":
                setattr(self, f"conv_layers_{i}_layer_norm",
                        LayerNorm(c, eps=cfg.layer_norm_eps))
            cin = c

    def forward(self, speech: torch.Tensor) -> torch.Tensor:
        """[B, N] -> [B, T, C]."""
        cfg = self.cfg
        x = speech[:, None, :]  # [B, 1, N]
        for i in range(len(cfg.conv_dim)):
            x = conv_in_dtype(getattr(self, f"conv_layers_{i}_conv"), x)
            if cfg.feat_extract_norm == "group" and i == 0:
                x = self.conv_layers_0_layer_norm(x)
            elif cfg.feat_extract_norm == "layer":
                x = getattr(self, f"conv_layers_{i}_layer_norm")(x.transpose(1, 2)).transpose(1, 2)
            x = F.gelu(x)
        return x.transpose(1, 2)


class _SelfAttention(nn.Module):
    """q (scaled after its bias), k, v, out projections and a key-masked
    float32 softmax (invalid keys at -1e10): ``_W2VAttention`` and
    ``_WhisperAttention`` of the JAX module, the latter with no k bias."""

    def __init__(self, d: int, heads: int, k_bias: bool = True):
        super().__init__()
        self.h, self.hd = heads, d // heads
        self.q_proj = Dense(d, d)
        self.k_proj = Dense(d, d, bias=k_bias)
        self.v_proj = Dense(d, d)
        self.out_proj = Dense(d, d)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q = (self.q_proj(x) * (self.hd ** -0.5)).reshape(b, t, self.h, self.hd)
        k = self.k_proj(x).reshape(b, t, self.h, self.hd)
        v = self.v_proj(x).reshape(b, t, self.h, self.hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        scores = scores.masked_fill(~valid[:, None, None, :], -1e10)
        attn = torch.softmax(scores.to(torch.promote_types(scores.dtype, torch.float32)),
                             dim=-1).to(x.dtype)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, d))


class _W2VLayer(nn.Module):
    """Post-norm (base) or pre-norm (``do_stable_layer_norm``, large) block."""

    def __init__(self, cfg: W2VConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.pre_norm = cfg.do_stable_layer_norm
        self.attention = _SelfAttention(d, cfg.num_attention_heads)
        self.layer_norm = LayerNorm(d, eps=eps)
        self.feed_forward_intermediate_dense = Dense(d, cfg.intermediate_size)
        self.feed_forward_output_dense = Dense(cfg.intermediate_size, d)
        self.final_layer_norm = LayerNorm(d, eps=eps)

    def _ff(self, z):
        return self.feed_forward_output_dense(F.gelu(self.feed_forward_intermediate_dense(z)))

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        if self.pre_norm:
            x, h = add_and_norm(x, self.attention(self.layer_norm(x), valid),
                                self.final_layer_norm)
            return x + self._ff(h)
        x = self.layer_norm(x, self.attention(x, valid))
        return self.final_layer_norm(x, self._ff(x))


class Wav2Vec2Encoder(nn.Module):
    """HF Wav2Vec2Model / HubertModel forward (eval mode):
    [B, N] raw 16 kHz audio -> ([B, T, hidden], [B] lengths clamped to T),
    computing in ``dtype`` from the waveform on."""

    def __init__(self, cfg: W2VConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        d, eps, k = cfg.hidden_size, cfg.layer_norm_eps, cfg.num_conv_pos_embeddings
        register_compute_dtype(self, dtype)
        self.feature_extractor = _W2VFeatureExtractor(cfg)
        self.feature_projection_layer_norm = LayerNorm(cfg.conv_dim[-1], eps=eps)
        self.feature_projection_projection = Dense(cfg.conv_dim[-1], d)
        # weight norm folded at conversion: one plain grouped conv
        self.pos_conv_embed_conv = nn.Conv1d(d, d, k, padding=k // 2,
                                             groups=cfg.num_conv_pos_embedding_groups)
        self.encoder_layer_norm = LayerNorm(d, eps=eps)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}", _W2VLayer(cfg))
        self.output_size = d

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        # the raw waveform in the compute dtype, as JAX casts it (:165)
        x = self.feature_extractor(to_compute(self, speech))
        lengths = torch.clamp(cfg.out_lengths(speech_lengths), max=x.shape[1])
        valid = make_valid_mask(lengths, x.shape[1])
        x = self.feature_projection_projection(self.feature_projection_layer_norm(x))
        x = x.masked_fill(~valid[..., None], 0.0)  # HF zeroes pads before the encoder
        pos = conv_in_dtype(self.pos_conv_embed_conv, x.transpose(1, 2)).transpose(1, 2)
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]
        if cfg.do_stable_layer_norm:
            x = x + F.gelu(pos)
        else:
            x = self.encoder_layer_norm(x, F.gelu(pos))
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x, valid)
        if cfg.do_stable_layer_norm:
            x = self.encoder_layer_norm(x)
        return x.masked_fill(~valid[..., None], 0.0), lengths


def _weight_norm_conv(sd: Mapping[str, torch.Tensor], prefix: str) -> np.ndarray:
    """A torch weight-norm conv weight (dim=2) materialised from the
    legacy (``weight_g``/``weight_v``) or the parametrize
    (``parametrizations.weight.original0/1``) layout, in numpy float32 as
    the JAX converter folds it."""
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    else:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    g, v = _np(g), _np(v)
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a), dtype=np.float32, order="C"))


def convert_hf_wav2vec2_state_dict(sd: Mapping[str, Any], cfg: W2VConfig
                                   ) -> Dict[str, torch.Tensor]:
    """HF Wav2Vec2Model/HubertModel state dict (a ``wav2vec2.``/``hubert.``
    prefix of a task head's checkpoint is taken off) -> the state dict of
    :class:`Wav2Vec2Encoder`, float32.  Torch layouts carry over; the
    positional conv's weight norm is folded."""
    sd = strip_prefix(dict(sd), ("wav2vec2.", "hubert."))
    out: Dict[str, torch.Tensor] = {}

    def copy(dst: str, src: str, bias: bool = True):
        out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
        if bias and f"{src}.bias" in sd:
            out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])

    for i in range(len(cfg.conv_dim)):
        copy(f"feature_extractor.conv_layers_{i}_conv",
             f"feature_extractor.conv_layers.{i}.conv", bias=cfg.conv_bias)
        if f"feature_extractor.conv_layers.{i}.layer_norm.weight" in sd:
            copy(f"feature_extractor.conv_layers_{i}_layer_norm",
                 f"feature_extractor.conv_layers.{i}.layer_norm")
    copy("feature_projection_layer_norm", "feature_projection.layer_norm")
    copy("feature_projection_projection", "feature_projection.projection")
    out["pos_conv_embed_conv.weight"] = _tensor(_weight_norm_conv(sd, "encoder.pos_conv_embed.conv"))
    out["pos_conv_embed_conv.bias"] = _tensor(sd["encoder.pos_conv_embed.conv.bias"])
    copy("encoder_layer_norm", "encoder.layer_norm")
    for i in range(cfg.num_hidden_layers):
        base = f"encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            copy(f"layers_{i}.attention.{proj}", f"{base}.attention.{proj}")
        copy(f"layers_{i}.layer_norm", f"{base}.layer_norm")
        copy(f"layers_{i}.feed_forward_intermediate_dense",
             f"{base}.feed_forward.intermediate_dense")
        copy(f"layers_{i}.feed_forward_output_dense", f"{base}.feed_forward.output_dense")
        copy(f"layers_{i}.final_layer_norm", f"{base}.final_layer_norm")
    return out


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WhisperEncConfig:
    d_model: int = 384
    encoder_layers: int = 4
    encoder_attention_heads: int = 6
    encoder_ffn_dim: int = 1536
    num_mel_bins: int = 80
    max_source_positions: int = 1500

    @classmethod
    def from_hf_config(cls, hf: Mapping[str, Any]) -> "WhisperEncConfig":
        return cls(**{f.name: hf.get(f.name, f.default) for f in dataclasses.fields(cls)})


class WhisperEncoder(nn.Module):
    """HF WhisperModel.encoder forward (eval): [B, T, n_mels] ->
    ([B, (T + 1) // 2, d], lengths (L + 1) // 2), computing in ``dtype``.
    More half-rate frames than ``max_source_positions`` raise, as the JAX
    slice does."""

    def __init__(self, cfg: WhisperEncConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        register_compute_dtype(self, dtype)
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Parameter(torch.zeros(cfg.max_source_positions, d))
        for i in range(cfg.encoder_layers):
            setattr(self, f"layers_{i}_self_attn_layer_norm", LayerNorm(d, eps=1e-5))
            setattr(self, f"layers_{i}_self_attn",
                    _SelfAttention(d, cfg.encoder_attention_heads, k_bias=False))
            setattr(self, f"layers_{i}_final_layer_norm", LayerNorm(d, eps=1e-5))
            setattr(self, f"layers_{i}_fc1", Dense(d, cfg.encoder_ffn_dim))
            setattr(self, f"layers_{i}_fc2", Dense(cfg.encoder_ffn_dim, d))
        self.layer_norm = LayerNorm(d, eps=1e-5)
        self.output_size = d

    def forward(self, feats: torch.Tensor, feats_lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = F.gelu(conv_in_dtype(self.conv1, to_compute(self, feats).transpose(1, 2)))
        x = F.gelu(conv_in_dtype(self.conv2, x)).transpose(1, 2)
        out_lengths = torch.div(feats_lengths + 1, 2, rounding_mode="floor")
        t = x.shape[1]
        if t > cfg.max_source_positions:
            raise ValueError(f"{t} encoder frames exceed max_source_positions="
                             f"{cfg.max_source_positions}")
        x = x + self.embed_positions[:t][None].to(x.dtype)
        valid = make_valid_mask(out_lengths, t)
        norms = [getattr(self, f"layers_{i}_self_attn_layer_norm")
                 for i in range(cfg.encoder_layers)] + [self.layer_norm]
        y = norms[0](x)
        for i in range(cfg.encoder_layers):
            x, y = add_and_norm(x, getattr(self, f"layers_{i}_self_attn")(y, valid),
                                getattr(self, f"layers_{i}_final_layer_norm"))
            y = getattr(self, f"layers_{i}_fc2")(F.gelu(getattr(self, f"layers_{i}_fc1")(y)))
            x, y = add_and_norm(x, y, norms[i + 1])
        return y.masked_fill(~valid[..., None], 0.0), out_lengths


def convert_hf_whisper_encoder_state_dict(sd: Mapping[str, Any], cfg: WhisperEncConfig
                                          ) -> Dict[str, torch.Tensor]:
    """HF WhisperModel.encoder state dict (or a whole WhisperModel's, with
    its ``encoder.`` prefix, or a WhisperForConditionalGeneration's with
    ``model.encoder.``) -> the state dict of :class:`WhisperEncoder`."""
    sd = strip_prefix(dict(sd), ("model.encoder.", "encoder."))
    out: Dict[str, torch.Tensor] = {}

    def copy(dst: str, src: str, bias: bool = True):
        out[f"{dst}.weight"] = _tensor(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = _tensor(sd[f"{src}.bias"])

    copy("conv1", "conv1")
    copy("conv2", "conv2")
    out["embed_positions"] = _tensor(sd["embed_positions.weight"])
    copy("layer_norm", "layer_norm")
    for i in range(cfg.encoder_layers):
        base = f"layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            copy(f"layers_{i}_self_attn.{proj}", f"{base}.self_attn.{proj}",
                 bias=proj != "k_proj")
        copy(f"layers_{i}_self_attn_layer_norm", f"{base}.self_attn_layer_norm")
        copy(f"layers_{i}_fc1", f"{base}.fc1")
        copy(f"layers_{i}_fc2", f"{base}.fc2")
        copy(f"layers_{i}_final_layer_norm", f"{base}.final_layer_norm")
    return out


# ---------------------------------------------------------------------------
# the ASR encoder wrapper and loading
# ---------------------------------------------------------------------------

SSL_KINDS = ("wav2vec2", "hubert", "whisper")


def ssl_config(kind: str, hf: Mapping[str, Any]):
    """The trunk config of ``kind`` from a parsed ``config.json``."""
    if kind not in SSL_KINDS:
        raise ValueError(f"unknown pretrained encoder kind {kind!r}; known: {SSL_KINDS}")
    return WhisperEncConfig.from_hf_config(hf) if kind == "whisper" else W2VConfig.from_hf_config(hf)


def make_ssl_trunk(kind: str, cfg, dtype: torch.dtype = torch.float32) -> nn.Module:
    return (WhisperEncoder if kind == "whisper" else Wav2Vec2Encoder)(cfg, dtype)


class SSLEncoderWrapper(nn.Module):
    """Pretrained trunk (``ssl``) + Linear to the model width
    (``output_proj``), pads zeroed: the ``wav2vec2_hf``/``hubert_hf``
    encoders read the raw waveform (``frontend: none``), ``whisper_hf`` mel
    frames; all in ``dtype``."""

    def __init__(self, kind: str, ssl_cfg, output_size: int,
                 device: Union[str, torch.device] = "cuda", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kind = kind
        self.output_size = output_size
        with torch.device(resolve_device(device)):
            self.ssl = make_ssl_trunk(kind, ssl_cfg, dtype)
            self.output_proj = Dense(self.ssl.output_size, output_size)

    def forward(self, feats, feats_lengths, rng=None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, out_lengths = self.ssl(feats, feats_lengths)
        x = self.output_proj(x)
        return x.masked_fill(~make_valid_mask(out_lengths, x.shape[1])[..., None], 0.0), out_lengths


def load_pretrained_encoder(name_or_path: Union[str, Path], kind: str
                            ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(trunk config, the trunk's state dict) of a local HF directory
    (``config.json`` and its weights); kind: wav2vec2 | hubert | whisper."""
    cfg = ssl_config(kind, read_hf_config(name_or_path))
    sd = load_hf_state_dict(name_or_path)
    if kind == "whisper":
        return cfg, convert_hf_whisper_encoder_state_dict(sd, cfg)
    return cfg, convert_hf_wav2vec2_state_dict(sd, cfg)
