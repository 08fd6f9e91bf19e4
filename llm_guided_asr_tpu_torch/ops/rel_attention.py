"""Relative-position self-attention (counterpart of llm_guided_asr_tpu/ops/rel_attention.py).

Transformer-XL scoring over [B, H, T, dk] operands with the dense position
table p [H, 2T-1, dk] (row T-1 is relative position 0):

    s[i, j] = qu_i . k_j + qv_i . p_{(T-1)-i+j}
    out_i   = softmax_j(mask(s[i, :]) * sm_scale) . v

On a CUDA tensor :func:`rel_attention` launches the hand-written kernel
``csrc/rel_attention.cu`` (forward only; the backward comes with the
training port); on a CPU tensor it runs :func:`rel_attention_plain`, the
dense einsum with the pad-reshape rel-shift.  Masked keys score -1e30 in
both, as in the TPU kernel; a row with at least one valid key is exact.
"""

from __future__ import annotations

import ctypes

import torch

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DK = 128

KERNEL = CudaKernel(
    "rel_attention.cu",
    {"rel_attention_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]},
    error_fn="rel_attention_error_string",
)


def rel_shift(x: torch.Tensor, t: int) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[i, j] = x[i, (T-1) - i + j]
    (espnet attention.py rel_shift, zero_triu=False)."""
    b, h, _, p = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(b, h, p + 1, t)[:, :, 1:]
    return x.reshape(b, h, t, p)[..., :t]


def rel_attention_plain(qu, qv, k, v, p, kv_valid, sm_scale: float) -> torch.Tensor:
    """Dense reference: materialises the [B, H, T, 2T-1] position scores and
    rel-shifts them; float32 throughout, output in the input type."""
    t = qu.shape[2]
    ac = torch.einsum("bhqd,bhkd->bhqk", qu.float(), k.float())
    bd = rel_shift(torch.einsum("bhqd,hpd->bhqp", qv.float(), p.float()), t)
    scores = (ac + bd) * sm_scale
    scores = scores.masked_fill(~(kv_valid[:, None, None, :] != 0), NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v.float()).to(qu.dtype)


def _check(qu, qv, k, v, p, kv_valid):
    if qu.dim() != 4:
        raise ValueError(f"rel_attention: qu must be [B, H, T, dk], got {tuple(qu.shape)}")
    b, h, t, dk = qu.shape
    for name, x in (("qv", qv), ("k", k), ("v", v)):
        if x.shape != qu.shape:
            raise ValueError(f"rel_attention: {name} {tuple(x.shape)} != qu {tuple(qu.shape)}")
    if tuple(p.shape) != (h, 2 * t - 1, dk):
        raise ValueError(f"rel_attention: p {tuple(p.shape)} != {(h, 2 * t - 1, dk)}")
    if tuple(kv_valid.shape) != (b, t):
        raise ValueError(f"rel_attention: kv_valid {tuple(kv_valid.shape)} != {(b, t)}")
    if qu.dtype not in _DTYPE_CODE or any(x.dtype != qu.dtype for x in (qv, k, v, p)):
        raise TypeError("rel_attention: qu, qv, k, v, p must share dtype float32 or bfloat16")
    if kv_valid.dtype != torch.int32:
        raise TypeError(f"rel_attention: kv_valid must be int32, got {kv_valid.dtype}")
    if any(x.device != qu.device for x in (qv, k, v, p, kv_valid)):
        raise ValueError("rel_attention: operands on different devices")


def rel_attention(qu, qv, k, v, p, kv_valid, sm_scale: float) -> torch.Tensor:
    """Fused rel-pos attention; see the module docstring for the contract."""
    _check(qu, qv, k, v, p, kv_valid)
    if qu.device.type == "cpu":
        return rel_attention_plain(qu, qv, k, v, p, kv_valid, sm_scale)
    if qu.device.type != "cuda":
        raise ValueError(f"rel_attention: unsupported device {qu.device}")
    b, h, t, dk = qu.shape
    if dk > MAX_DK:
        raise ValueError(f"rel_attention: head dim {dk} > {MAX_DK} is not supported by the kernel")
    if not all(x.is_contiguous() for x in (qu, qv, k, v, p, kv_valid)):
        raise ValueError("rel_attention: operands must be contiguous")
    out = torch.empty_like(qu)
    if out.numel() == 0:
        return out
    with torch.cuda.device(qu.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("rel_attention_fwd", qu.data_ptr(), qv.data_ptr(), k.data_ptr(),
                      v.data_ptr(), p.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
                      b, h, t, dk, float(sm_scale), _DTYPE_CODE[qu.dtype], stream)
    return out
