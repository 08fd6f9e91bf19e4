"""Depthwise 1-D convolution (counterpart of llm_guided_asr_tpu/ops/depthwise_conv.py).

Layout x [B, T, C], w [K, C]; SAME zero padding with pad_l = (K-1)//2
(lax convention: an even K pads one less on the left).
:func:`depthwise_conv1d` is an autograd function: on CUDA tensors its
forward and backward launch the hand-written kernels of
``csrc/depthwise_conv.cu``; on CPU tensors they run
:func:`depthwise_conv1d_plain` and :func:`depthwise_conv1d_bwd_plain`, the
JAX package's decomposed VJP.  The backward kernel sums dw from per-slab
partials (:func:`dw_slabs` slabs of rows per batch row) that it writes to a
float32 workspace the wrapper allocates, and adds them in a fixed order:
no atomics, so a repeat call is bitwise equal, dw included.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

KERNEL = CudaKernel(
    "depthwise_conv.cu",
    {
        "dwconv1d_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "dwconv1d_bwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    },
    error_fn="dwconv1d_error_string",
    queries={"dwconv1d_bwd_slabs": [ctypes.c_int] * 4},
)


def _pads(k_size: int) -> Tuple[int, int]:
    pad_l = (k_size - 1) // 2
    return pad_l, k_size - 1 - pad_l


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Explicit sum of K shifted products, accumulated in float32."""
    t = x.shape[1]
    k_size = w.shape[0]
    pad_l, pad_r = _pads(k_size)
    xp = F.pad(x.float(), (0, 0, pad_l, pad_r))
    wf = w.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(k_size):
        acc += xp[:, k : k + t, :] * wf[k]
    return acc.to(x.dtype)


def depthwise_conv1d_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                               dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decomposed VJP: dx is dy, padded pad_r left and pad_l right,
    correlated with the flipped taps; dw[k] = sum_{b,t} dy * x shifted by
    k - pad_l.  Float32 sums; dx in x's type, dw in w's."""
    t = x.shape[1]
    k_size = w.shape[0]
    pad_l, pad_r = _pads(k_size)
    dyp = F.pad(dy.float(), (0, 0, pad_r, pad_l))
    xp = F.pad(x.float(), (0, 0, pad_l, pad_r))
    wf, dyf = w.float(), dy.float()
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for m in range(k_size):
        dx += dyp[:, m : m + t, :] * wf[k_size - 1 - m]
    dw = torch.stack([(dyf * xp[:, k : k + t, :]).sum(dim=(0, 1)) for k in range(k_size)])
    return dx.to(x.dtype), dw.to(w.dtype)


def _check_card(*xs):
    if xs[0].device.type != "cuda":
        raise ValueError(f"depthwise_conv1d: unsupported device {xs[0].device}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("depthwise_conv1d: x and w must be contiguous")


def _fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w)
    _check_card(x, w)
    b, t, c = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        KERNEL.launch("dwconv1d_fwd", x.data_ptr(), w.data_ptr(), y.data_ptr(),
                      b, t, c, w.shape[0], _DTYPE_CODE[x.dtype],
                      torch.cuda.current_stream().cuda_stream)
    return y


def depthwise_conv1d_bwd(x: torch.Tensor, w: torch.Tensor,
                         dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`depthwise_conv1d` for the output gradient ``dy``:
    the plain VJP on CPU tensors, the kernel on CUDA tensors (dw summed in
    float32 in a fixed order, returned in w's type)."""
    _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("depthwise_conv1d_bwd: dy must match x in shape, dtype and device")
    if x.device.type == "cpu":
        return depthwise_conv1d_bwd_plain(x, w, dy)
    _check_card(x, w, dy)
    b, t, c = x.shape
    k_size = w.shape[0]
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    with torch.cuda.device(x.device):
        slabs = dw_slabs(x, k_size)
        # each slab's partial dw, which the kernel sums in a fixed order
        work = torch.empty(b * slabs * k_size * c, dtype=torch.float32, device=x.device)
        KERNEL.launch("dwconv1d_bwd", dy.data_ptr(), x.data_ptr(), w.data_ptr(),
                      dx.data_ptr(), dw.data_ptr(), work.data_ptr(), slabs, b, t, c, k_size,
                      _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    return dx, dw.to(w.dtype)


def dw_slabs(x: torch.Tensor, k_size: int) -> int:
    """The slabs of rows a batch row that the backward kernel sums dw over
    for x's [B, T, C] shape and K = ``k_size`` on x's device (a CUDA
    tensor); the workspace holds B * slabs partials of [K, C]."""
    return _dw_slabs(x.device.index, *x.shape, k_size)


@functools.lru_cache(maxsize=1024)
def _dw_slabs(device_index, b, t, c, k_size) -> int:
    with torch.cuda.device(device_index):
        n = KERNEL.query("dwconv1d_bwd_slabs", b, t, c, k_size)
    if n < 1:
        raise RuntimeError(f"dwconv1d_bwd_slabs failed: CUDA error {-n}")
    return n


class _DepthwiseConv1dFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return depthwise_conv1d_bwd(x, w, dy.contiguous())


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"depthwise_conv1d: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"depthwise_conv1d: dtypes {x.dtype}/{w.dtype}; need matching f32 or bf16")
    if w.device != x.device:
        raise ValueError("depthwise_conv1d: x and w on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, C], [K, C] -> [B, T, C] depthwise conv, SAME zero padding."""
    _check(x, w)
    return _DepthwiseConv1dFn.apply(x, w)
