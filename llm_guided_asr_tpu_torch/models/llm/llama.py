"""Llama decoder-only LM (counterpart of llm_guided_asr_tpu/models/llm/llama.py).

RMSNorm, RoPE with optional llama3 scaling, SwiGLU MLP, grouped-query
attention without repeating K/V, and a KV cache for decoding.  Pads may sit
inside a row: positions default to cumsum(valid)-1 and pads are masked
from the attention keys.

``return_logits`` adds the vocabulary projection: the embedding matrix
when ``tie_word_embeddings``, else an ``lm_head``, which the model holds
only when built with ``lm_head=True`` (a caller that reads hidden states
alone loads no head).

Weights come from a local Hugging Face checkpoint directory
(:func:`load_llama_dir`: ``config.json`` and ``model.safetensors``, or the
shards that ``model.safetensors.index.json`` names; no hub lookup).
:func:`stream_checkpoint` reads them tensor by tensor through the reader
of models/hf_checkpoint.py, so the host holds one tensor at a time, and
:func:`convert_hf_state_dict` maps the names.

Attention follows the JAX module's type promotion: scores and the value
product run in the common type of q and the keys, so a bfloat16 model that
attends over a float32 cache computes that attention in float32.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.hf_checkpoint import (  # noqa: F401 (re-exported)
    checkpoint_files,
    iter_safetensors,
    load_safetensors,
)
from llm_guided_asr_tpu_torch.models.transformer import Dense
from llm_guided_asr_tpu_torch.utils.device import resolve_device

NEG_INF = -1.0e9


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    attention_bias: bool = False  # True for Qwen2
    tie_word_embeddings: bool = False
    # llama3-style rope scaling (None to disable)
    rope_scaling_factor: Optional[float] = None
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, hf: Mapping[str, Any]) -> "LlamaConfig":
        """From a parsed ``config.json`` (Llama or Qwen2)."""
        rope_scaling = hf.get("rope_scaling") or {}
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type"))
        kw = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            rms_norm_eps=hf["rms_norm_eps"],
            rope_theta=hf.get("rope_theta", 10000.0),
            max_position_embeddings=hf["max_position_embeddings"],
            attention_bias=hf.get("attention_bias", hf.get("model_type") == "qwen2"),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )
        if rope_type == "llama3":
            kw.update(
                rope_scaling_factor=rope_scaling["factor"],
                rope_low_freq_factor=rope_scaling["low_freq_factor"],
                rope_high_freq_factor=rope_scaling["high_freq_factor"],
                rope_original_max_position=rope_scaling["original_max_position_embeddings"],
            )
        return cls(**kw)


def rope_frequencies(cfg: LlamaConfig) -> np.ndarray:
    """Inverse frequencies, with optional llama3 NTK-by-parts scaling."""
    head_dim = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if cfg.rope_scaling_factor is not None:
        low_wl = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high_wl = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2.0 * np.pi / inv_freq
        scaled = inv_freq / cfg.rope_scaling_factor
        smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        smoothed = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(
            wavelen < high_wl, inv_freq, np.where(wavelen > low_wl, scaled, smoothed)
        )
    return inv_freq.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D]; positions [B, T] -> rotated x (HF rotate_half layout)."""
    angles = positions[..., None].float() * inv_freq  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.weight.float()).to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        bias = cfg.attention_bias
        self.q_proj = Dense(cfg.hidden_size, h * hd, bias=bias, dtype=dtype)
        self.k_proj = Dense(cfg.hidden_size, hkv * hd, bias=bias, dtype=dtype)
        self.v_proj = Dense(cfg.hidden_size, hkv * hd, bias=bias, dtype=dtype)
        self.o_proj = Dense(h * hd, cfg.hidden_size, bias=False, dtype=dtype)

    def forward(self, x, positions, attn_mask, inv_freq, cache=None, cache_write_pos=None):
        """x [B, T, D]; attn_mask [B, T, Tk] (True = attend, causality included).

        cache: optional (k, v) [B, Tc, Hkv, hd] buffers, with T = 1: the new
        token's k/v are written IN PLACE into the buffers at
        ``cache_write_pos`` (the JAX model writes the same values with
        dynamic_update_slice) and the keys are the buffers alone.  Returns
        the new tokens' (k, v) as well.
        """
        cfg = self.cfg
        h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        b, t = x.shape[:2]
        q = apply_rope(self.q_proj(x).reshape(b, t, h, hd), positions, inv_freq)
        k = apply_rope(self.k_proj(x).reshape(b, t, hkv, hd), positions, inv_freq)
        v = self.v_proj(x).reshape(b, t, hkv, hd)
        new_kv = (k, v)
        if cache is not None:
            ck, cv = cache
            ck[:, cache_write_pos] = k[:, 0].to(ck.dtype)
            cv[:, cache_write_pos] = v[:, 0].to(cv.dtype)
            k, v = ck, cv
        ct = torch.promote_types(q.dtype, k.dtype)
        rep = h // hkv
        # grouped-query attention without materialising the repeated k/v
        qg = q.to(ct).reshape(b, t, hkv, rep, hd)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(ct)) / math.sqrt(hd)
        scores = scores.masked_fill(~attn_mask[:, None, None], NEG_INF)
        attn = torch.softmax(scores.float(), dim=-1).to(ct)
        out = torch.einsum("bgrqk,bkgd->bqgrd", attn, v.to(ct)).reshape(b, t, h * hd)
        return self.o_proj(out.to(x.dtype)), new_kv


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32):
        super().__init__()
        self.gate_proj = Dense(cfg.hidden_size, cfg.intermediate_size, bias=False, dtype=dtype)
        self.up_proj = Dense(cfg.hidden_size, cfg.intermediate_size, bias=False, dtype=dtype)
        self.down_proj = Dense(cfg.intermediate_size, cfg.hidden_size, bias=False, dtype=dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.float32):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.self_attn = LlamaAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.mlp = LlamaMLP(cfg, dtype)

    def forward(self, x, positions, attn_mask, inv_freq, cache=None, cache_write_pos=None):
        h, new_kv = self.self_attn(self.input_layernorm(x), positions, attn_mask, inv_freq,
                                   cache, cache_write_pos)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), new_kv


class LlamaModel(nn.Module):
    """Final hidden states (after ``norm``) and per-layer (k, v)."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 device: Union[str, torch.device] = "cuda", lm_head: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        # the type the blocks compute in when it is not the parameters'
        # (flax's ``dtype`` over float32 parameters): the embedding rows
        # are cast to it and every projection casts its weight to its input
        self.compute_dtype = compute_dtype
        with torch.device(dev):
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
            for i in range(cfg.num_hidden_layers):
                setattr(self, f"layers_{i}", LlamaBlock(cfg, dtype))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
            if lm_head and not cfg.tie_word_embeddings:
                self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype)
            self.register_buffer("inv_freq", torch.tensor(rope_frequencies(cfg)),
                                 persistent=False)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T]
        valid: torch.Tensor,  # [B, T] bool (False = pad, possibly mid-row)
        cache: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
        cache_valid: Optional[torch.Tensor] = None,  # [B, Tc] validity of cache keys
        positions: Optional[torch.Tensor] = None,  # [B, T]; default cumsum(valid)-1
        cache_write_pos: Optional[int] = None,  # slot of the new token in the cache
        return_logits: bool = False,
        embed_override: Optional[torch.Tensor] = None,  # [B, T, H]
        override_mask: Optional[torch.Tensor] = None,  # [B, T] bool: use the override
    ):
        """-> (hidden, per-layer (k, v)), or (hidden, logits, per-layer
        (k, v)) with ``return_logits``.  ``embed_override`` replaces the
        token embeddings where ``override_mask`` is True (the projected
        encoder frames of models/hf_decoder.py)."""
        b, t = input_ids.shape
        if positions is None:
            positions = torch.clamp(torch.cumsum(valid.int(), dim=1) - 1, min=0)
        if cache is not None:
            if cache_write_pos is None or t != 1:
                raise ValueError("a cached decode step takes one new token and its cache slot")
            keys_valid = cache_valid.clone()
            keys_valid[:, cache_write_pos] = True  # the query's own slot
            qk_mask = keys_valid[:, None, :].expand(b, t, keys_valid.shape[1])
        else:
            causal = torch.ones(t, t, dtype=torch.bool, device=input_ids.device).tril()
            qk_mask = causal[None] & valid[:, None, :] & valid[:, :, None]
        x = self.embed_tokens(input_ids)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        if embed_override is not None:
            x = torch.where(override_mask[..., None], embed_override.to(x.dtype), x)
        new_cache = []
        for i in range(self.cfg.num_hidden_layers):
            layer_cache = None if cache is None else cache[i]
            x, kv = getattr(self, f"layers_{i}")(x, positions, qk_mask, self.inv_freq,
                                                 layer_cache, cache_write_pos)
            new_cache.append(kv)
        x = self.norm(x)
        if return_logits:
            if self.cfg.tie_word_embeddings:
                logits = x @ self.embed_tokens.weight.to(x.dtype).t()
            elif hasattr(self, "lm_head"):
                logits = self.lm_head(x)
            else:
                raise ValueError("return_logits needs a LlamaModel built with lm_head=True")
            return x, logits, new_cache
        return x, new_cache


# ---------------------------------------------------------------------------
# Hugging Face checkpoints
# ---------------------------------------------------------------------------

def stream_checkpoint(model_dir: Union[str, Path], cfg: LlamaConfig,
                      dtype: Optional[torch.dtype] = None,
                      device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """A Hugging Face checkpoint directory (one file or shards) -> the port's
    :class:`LlamaModel` state dict, tensor by tensor: each is read, renamed
    (:func:`hf_to_port_name`), cast to ``dtype`` (default float32) and moved
    to ``device`` before the next is read, so the host holds one tensor at a
    time.  No thread: nothing is left running if a read raises."""
    dtype = torch.float32 if dtype is None else dtype
    out: Dict[str, torch.Tensor] = {}
    for path in checkpoint_files(model_dir):
        for hf_name, t in iter_safetensors(path):
            name = hf_to_port_name(hf_name, cfg)
            if name is not None:
                out[name] = t.to(device=device, dtype=dtype)
    return out


def hf_to_port_name(name: str, cfg: LlamaConfig) -> Optional[str]:
    """A ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` tensor name -> the port's
    :class:`LlamaModel` name (the JAX tree's path joined by dots), or None
    for a tensor the model does not hold: q/k/v biases without
    ``cfg.attention_bias``, ``lm_head.weight`` of a tied head, rotary
    buffers."""
    if name == "model.embed_tokens.weight":
        return "embed_tokens.weight"
    if name == "model.norm.weight":
        return "norm.weight"
    if name == "lm_head.weight":
        return None if cfg.tie_word_embeddings else name
    if not name.startswith("model.layers."):
        return None
    i, _, tail = name[len("model.layers."):].partition(".")
    if tail in ("input_layernorm.weight", "post_attention_layernorm.weight"):
        return f"layers_{i}.{tail}"
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        if tail == f"self_attn.{proj}.weight":
            return f"layers_{i}.{tail}"
        if tail == f"self_attn.{proj}.bias":
            return f"layers_{i}.{tail}" if cfg.attention_bias and proj != "o_proj" else None
    for proj in ("gate_proj", "up_proj", "down_proj"):
        if tail == f"mlp.{proj}.weight":
            return f"layers_{i}.{tail}"
    return None


def convert_hf_state_dict(state_dict: Mapping[str, Any], cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """A ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` state dict -> the port's
    :class:`LlamaModel` state dict in float32 (names by
    :func:`hf_to_port_name`; torch layouts need no transpose).
    ``lm_head.weight`` is kept where the head is not tied to the embedding;
    a caller whose model has no head drops that key."""
    sd = {}
    for hf_name, w in state_dict.items():
        name = hf_to_port_name(hf_name, cfg)
        if name is not None:
            sd[name] = w.float() if isinstance(w, torch.Tensor) else torch.from_numpy(
                np.asarray(w, dtype=np.float32))
    for required in ("embed_tokens.weight", "norm.weight"):
        if required not in sd:
            raise KeyError(f"the checkpoint has no {required!r}")
    return sd


def load_llama_dir(path: Union[str, Path], dtype: Optional[torch.dtype] = None,
                   device: Union[str, torch.device] = "cpu"
                   ) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """A local checkpoint directory (``config.json`` and ``model.safetensors``
    or its shards) -> (config, state dict streamed by
    :func:`stream_checkpoint`, float32 by default).  No hub lookup."""
    path = Path(path)
    cfg = LlamaConfig.from_hf_config(json.loads((path / "config.json").read_text()))
    return cfg, stream_checkpoint(path, cfg, dtype, device)
