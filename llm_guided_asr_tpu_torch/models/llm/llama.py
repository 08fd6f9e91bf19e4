"""Llama decoder-only LM (counterpart of llm_guided_asr_tpu/models/llm/llama.py).

RMSNorm, RoPE with optional llama3 scaling, SwiGLU MLP, grouped-query
attention without repeating K/V, and a KV cache for decoding.  Pads may sit
inside a row: positions default to cumsum(valid)-1 and pads are masked
from the attention keys.

Weights come from a local Hugging Face checkpoint directory
(:func:`load_llama_dir`: ``config.json`` and ``model.safetensors``, read by
:func:`load_safetensors` with the standard library and numpy, no hub
lookup) through :func:`convert_hf_state_dict`.

Attention follows the JAX module's type promotion: scores and the value
product run in the common type of q and the keys, so a bfloat16 model that
attends over a float32 cache computes that attention in float32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
        self.q_proj = nn.Linear(cfg.hidden_size, h * hd, bias=bias, dtype=dtype)
        self.k_proj = nn.Linear(cfg.hidden_size, hkv * hd, bias=bias, dtype=dtype)
        self.v_proj = nn.Linear(cfg.hidden_size, hkv * hd, bias=bias, dtype=dtype)
        self.o_proj = nn.Linear(h * hd, cfg.hidden_size, bias=False, dtype=dtype)

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
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False, dtype=dtype)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False, dtype=dtype)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False, dtype=dtype)

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
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype
        with torch.device(dev):
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
            for i in range(cfg.num_hidden_layers):
                setattr(self, f"layers_{i}", LlamaBlock(cfg, dtype))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
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
    ):
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
        new_cache = []
        for i in range(self.cfg.num_hidden_layers):
            layer_cache = None if cache is None else cache[i]
            x, kv = getattr(self, f"layers_{i}")(x, positions, qk_mask, self.inv_freq,
                                                 layer_cache, cache_write_pos)
            new_cache.append(kv)
        return self.norm(x), new_cache


# ---------------------------------------------------------------------------
# Hugging Face checkpoints
# ---------------------------------------------------------------------------

# safetensors dtype -> (numpy type the bytes are read as, torch type)
_SAFETENSORS_TYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def load_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor in the file's type}.

    The format: an 8-byte little-endian header length, a JSON header of
    ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (and an
    optional ``__metadata__``), then the raw little-endian bytes.  Read
    with the standard library and numpy; BF16 is read as 16-bit integers
    and viewed as torch.bfloat16, bit for bit.
    """
    with open(path, "rb") as f:
        (n_header,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n_header))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_TYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        np_type, torch_type = _SAFETENSORS_TYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=np.dtype(np_type).newbyteorder("<"),
                            count=(end - begin) // np.dtype(np_type).itemsize, offset=begin)
        t = torch.from_numpy(arr.astype(np_type, copy=True)).reshape(info["shape"])
        out[name] = t.view(torch_type) if torch_type == torch.bfloat16 else t
    return out


def convert_hf_state_dict(state_dict: Mapping[str, Any], cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """A ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` state dict -> the port's
    :class:`LlamaModel` state dict in float32 (the names of the JAX
    package's tree joined by dots; torch layouts need no transpose).
    q/k/v biases are taken where ``cfg.attention_bias`` and the checkpoint
    has them; ``lm_head.weight`` is returned too where the head is not tied
    to the embedding (the model itself returns hidden states, so a caller
    loading it drops that key)."""

    def a(name):
        w = state_dict[name]
        return w.float() if isinstance(w, torch.Tensor) else torch.from_numpy(
            np.asarray(w, dtype=np.float32))

    sd = {"embed_tokens.weight": a("model.embed_tokens.weight"),
          "norm.weight": a("model.norm.weight")}
    for i in range(cfg.num_hidden_layers):
        src, dst = f"model.layers.{i}", f"layers_{i}"
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{dst}.{name}.weight"] = a(f"{src}.{name}.weight")
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{dst}.mlp.{proj}.weight"] = a(f"{src}.mlp.{proj}.weight")
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{dst}.self_attn.{proj}.weight"] = a(f"{src}.self_attn.{proj}.weight")
            bias = f"{src}.self_attn.{proj}.bias"
            if cfg.attention_bias and bias in state_dict and proj != "o_proj":
                sd[f"{dst}.self_attn.{proj}.bias"] = a(bias)
    if not cfg.tie_word_embeddings and "lm_head.weight" in state_dict:
        sd["lm_head.weight"] = a("lm_head.weight")
    return sd


def load_llama_dir(path: Union[str, Path]) -> Tuple[LlamaConfig, Dict[str, torch.Tensor]]:
    """A local checkpoint directory (``config.json`` and
    ``model.safetensors``) -> (config, :func:`convert_hf_state_dict` of its
    weights).  No hub lookup: the directory must hold both files."""
    path = Path(path)
    cfg = LlamaConfig.from_hf_config(json.loads((path / "config.json").read_text()))
    return cfg, convert_hf_state_dict(load_safetensors(path / "model.safetensors"), cfg)
