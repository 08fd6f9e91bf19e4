"""Llama decoder-only LM (counterpart of llm_guided_asr_tpu/models/llm/llama.py).

RMSNorm, RoPE with optional llama3 scaling, SwiGLU MLP, grouped-query
attention without repeating K/V, and a KV cache for decoding.  Pads may sit
inside a row: positions default to cumsum(valid)-1 and pads are masked
from the attention keys.

Attention follows the JAX module's type promotion: scores and the value
product run in the common type of q and the keys, so a bfloat16 model that
attends over a float32 cache computes that attention in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

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
