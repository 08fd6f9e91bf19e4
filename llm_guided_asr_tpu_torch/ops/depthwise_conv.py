"""Depthwise 1-D convolution (counterpart of llm_guided_asr_tpu/ops/depthwise_conv.py).

Layout x [B, T, C], w [K, C]; SAME zero padding with pad_l = (K-1)//2
(lax convention: an even K pads one less on the left).  On a CUDA tensor
:func:`depthwise_conv1d` launches the hand-written kernel
``csrc/depthwise_conv.cu`` (forward only; the backward comes with the
training port); on a CPU tensor it runs :func:`depthwise_conv1d_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "depthwise_conv.cu",
    {"dwconv1d_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]},
    error_fn="dwconv1d_error_string",
)


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Explicit sum of K shifted products, accumulated in float32."""
    t = x.shape[1]
    k_size = w.shape[0]
    pad_l = (k_size - 1) // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, pad_l, k_size - 1 - pad_l))
    wf = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(k_size):
        acc += xp[:, k : k + t, :] * wf[k]
    return acc.to(x.dtype)


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, C], [K, C] -> [B, T, C] depthwise conv, SAME zero padding."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"depthwise_conv1d: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"depthwise_conv1d: dtypes {x.dtype}/{w.dtype}; need matching f32 or bf16")
    if w.device != x.device:
        raise ValueError("depthwise_conv1d: x and w on different devices")
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise_conv1d: x and w must be contiguous")
    b, t, c = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("dwconv1d_fwd", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                      b, t, c, w.shape[0], _DTYPE_CODE[x.dtype], stream)
    return y
