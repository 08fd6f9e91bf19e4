"""RWKV WKV recurrence (counterpart of llm_guided_asr_tpu/ops/wkv.py).

Per batch row and channel, over T steps, with ``w = -exp(time_decay)``
([C], computed in float32 by the caller) and ``u = time_first`` [C], the
state (aa, bb, pp) holds aa * e^pp and bb * e^pp under a running maximum:

    ww = u + k[t];  q = max(pp, ww);  e1 = exp(pp - q);  e2 = exp(ww - q)
    y[t] = (e1 * aa + e2 * v[t]) / (e1 * bb + e2)
    ww = pp + w;    q = max(ww, k[t]); e1 = exp(ww - q);  e2 = exp(k[t] - q)
    aa = e1 * aa + e2 * v[t];  bb = e1 * bb + e2;  pp = q

``k`` and ``v`` are [B, T, C]; everything is computed in float32 and y
comes back in k's type.  :func:`wkv_scan` is the plain version (a Python
loop over T).  :func:`wkv_fwd` and :func:`wkv_bwd` are the entry points of
the hand-written kernels of ``csrc/wkv.cu`` on CUDA tensors and run the
plain version on CPU tensors.  :func:`wkv` is the differentiable front
door (the JAX custom VJP): an autograd function whose forward is
:func:`wkv_fwd` from the initial state and whose backward is
:func:`wkv_bwd`.

The forward kernel is a chunked scan: it cuts T into :func:`chunks`
pieces, scans each from the zero state into a summary kept in a float32
workspace that the wrapper allocates, folds the summaries in a fixed
order and rescans each chunk from the state it carried in.  No atomics:
a repeat call is bitwise equal.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

WKVState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (aa, bb, pp), each [B, C]

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "wkv.cu",
    {
        "wkv_fwd": [_P] * 12 + [_I] * 4 + [_P],
        "wkv_bwd": [_P] * 10 + [_I] * 3 + [_P],
    },
    error_fn="wkv_error_string",
    queries={"wkv_fwd_chunks": [_I] * 3},
)


def wkv_init_state(batch: int, channels: int,
                   device: Optional[torch.device] = None) -> WKVState:
    """aa = bb = 0 and pp = -1e38 (finite in float32)."""
    return (
        torch.zeros((batch, channels), dtype=torch.float32, device=device),
        torch.zeros((batch, channels), dtype=torch.float32, device=device),
        torch.full((batch, channels), -1e38, dtype=torch.float32, device=device),
    )


def wkv_scan(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             state: Optional[WKVState] = None) -> Tuple[torch.Tensor, WKVState]:
    """The plain version: the recurrence as a loop over T in float32;
    differentiable by autograd.  Returns (y in k's type, final state)."""
    b, t, c = k.shape
    if state is None:
        state = wkv_init_state(b, c, k.device)
    aa, bb, pp = state
    kf, vf = k.float(), v.float()
    ys = []
    for i in range(t):
        kt, vt = kf[:, i], vf[:, i]
        ww = u + kt
        q = torch.maximum(pp, ww)
        e1 = torch.exp(pp - q)
        e2 = torch.exp(ww - q)
        ys.append((e1 * aa + e2 * vt) / (e1 * bb + e2))
        ww2 = pp + w
        q2 = torch.maximum(ww2, kt)
        e1b = torch.exp(ww2 - q2)
        e2b = torch.exp(kt - q2)
        aa, bb, pp = e1b * aa + e2b * vt, e1b * bb + e2b, q2
    y = torch.stack(ys, dim=1) if ys else kf.new_zeros((b, 0, c))
    return y.to(k.dtype), (aa, bb, pp)


def wkv_bwd_plain(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  gy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(gw, gu, gk, gv) by autograd through :func:`wkv_scan` from the
    initial state (the JAX package's backward, the VJP of the scan)."""
    with torch.enable_grad():
        leaves = [x.detach().float().requires_grad_(True) for x in (w, u, k, v)]
        y, _ = wkv_scan(*leaves)
        gw, gu, gk, gv = torch.autograd.grad(y, leaves, gy.float(), allow_unused=True,
                                             materialize_grads=True)  # T = 0: zeros
    return gw, gu, gk.to(k.dtype), gv.to(v.dtype)


def _check(w, u, k, v) -> None:
    if k.dim() != 3 or v.shape != k.shape or w.shape != (k.shape[2],) or u.shape != w.shape:
        raise ValueError(f"wkv: bad shapes w{tuple(w.shape)} u{tuple(u.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv: w and u must be float32, got {w.dtype}/{u.dtype}")
    if not (k.dtype.is_floating_point and v.dtype == k.dtype):
        raise TypeError(f"wkv: k and v must share one floating type, got {k.dtype}/{v.dtype}")
    if len({x.device for x in (w, u, k, v)}) != 1:
        raise ValueError("wkv: inputs on different devices")
    if k.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv: unsupported device {k.device}")


def _check_card(*xs) -> None:
    for x in xs:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("wkv: the kernel takes contiguous float32 tensors")


def wkv_fwd(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            state: Optional[WKVState] = None) -> Tuple[torch.Tensor, WKVState]:
    """(y, final state) from ``state`` (the initial one when None): the
    contract of the TPU kernel's wkv_pallas.  The plain loop on CPU
    tensors, the kernel ``wkv_fwd`` on CUDA tensors (k and v cast to
    float32 first, as wkv_pallas casts them)."""
    _check(w, u, k, v)
    b, t, c = k.shape
    if state is not None and (len(state) != 3 or any(
            s.shape != (b, c) or s.dtype != torch.float32 or s.device != k.device
            for s in state)):
        raise ValueError(f"wkv: the state must be three float32 [{b}, {c}] tensors on {k.device}")
    return _fwd(w, u, k, v, state, True)


def _fwd(w, u, k, v, state: Optional[WKVState], want_state: bool):
    """wkv_fwd after the checks; on the card, no initial state and
    ``want_state`` False launch the kernel without any state buffer."""
    if k.device.type == "cpu":
        return wkv_scan(w, u, k, v, state)
    b, t, c = k.shape
    kf, vf = k.float().contiguous(), v.float().contiguous()
    state0 = [s.contiguous() for s in state] if state is not None else []
    _check_card(w, u, kf, vf, *state0)
    y = torch.empty_like(kf)
    state1 = [torch.empty((b, c), dtype=torch.float32, device=k.device)
              for _ in range(3 if want_state else 0)]
    # null pointers: start from the initial state / store no final state
    ptrs0 = [s.data_ptr() for s in state0] or [None] * 3
    ptrs1 = [s.data_ptr() for s in state1] or [None] * 3
    if b * c > 0:
        with torch.cuda.device(k.device):
            n = chunks(k)
            # the chunk summaries (a, b, p), which the kernel folds in order
            work = (torch.empty(3 * b * n * c, dtype=torch.float32, device=k.device)
                    if n > 1 else None)
            KERNEL.launch("wkv_fwd", w.data_ptr(), u.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                          *ptrs0, None if work is None else work.data_ptr(), y.data_ptr(),
                          *ptrs1, n, b, t, c, torch.cuda.current_stream().cuda_stream)
    return y.to(k.dtype), (tuple(state1) if want_state else None)


def chunks(k: torch.Tensor) -> int:
    """The chunks the forward kernel cuts T into for k's [B, T, C] shape on
    its device (a CUDA tensor): more than 1 only where one warp per 32
    channels would leave the card part idle and the chunks stay long."""
    return _chunks(k.device.index, *k.shape)


@functools.lru_cache(maxsize=4096)
def _chunks(device_index, b, t, c) -> int:
    with torch.cuda.device(device_index):
        n = KERNEL.query("wkv_fwd_chunks", b, t, c)
    if n < 1:
        raise RuntimeError(f"wkv_fwd_chunks failed: CUDA error {-n}")
    return n


def wkv_bwd(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            y: torch.Tensor, gy: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients (gw, gu, gk, gv) of y = wkv(w, u, k, v) for the output
    gradient ``gy``: gw and gu [C] float32 summed over the batch, gk and gv
    in k's type.  ``y`` is the forward's output.  On CPU tensors this is
    :func:`wkv_bwd_plain` (y unused); on CUDA tensors the kernel, whose gw
    and gu are float32 atomic sums over the batch (their last bits may
    change from run to run)."""
    _check(w, u, k, v)
    if y.shape != k.shape or gy.shape != k.shape:
        raise ValueError("wkv_bwd: y and gy must have k's shape")
    if k.device.type == "cpu":
        return wkv_bwd_plain(w, u, k, v, gy)
    kf, vf, yf, gyf = (x.float().contiguous() for x in (k, v, y, gy))
    _check_card(w, u, kf, vf, yf, gyf)
    b, t, c = k.shape
    gw, gu = torch.zeros_like(w), torch.zeros_like(u)
    gk, gv = torch.empty_like(kf), torch.empty_like(vf)
    if b * c > 0:
        with torch.cuda.device(k.device):
            KERNEL.launch("wkv_bwd", w.data_ptr(), u.data_ptr(), kf.data_ptr(), vf.data_ptr(),
                          yf.data_ptr(), gyf.data_ptr(), gw.data_ptr(), gu.data_ptr(),
                          gk.data_ptr(), gv.data_ptr(), b, t, c,
                          torch.cuda.current_stream().cuda_stream)
    return gw, gu, gk.to(k.dtype), gv.to(v.dtype)


class _WKVFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, u, k, v):
        y, _ = _fwd(w, u, k, v, None, False)
        ctx.save_for_backward(w, u, k, v, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        w, u, k, v, y = ctx.saved_tensors
        return wkv_bwd(w, u, k, v, y, gy.contiguous())


def wkv(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y [B, T, C] of the recurrence from the initial state; differentiable
    in w, u, k and v.  A call that needs no gradient runs the forward only."""
    _check(w, u, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (w, u, k, v)):
        return _WKVFn.apply(w, u, k, v)
    return _fwd(w, u, k, v, None, False)[0]
