"""Flash self-attention over valid frames (counterpart of the library flash
attention that llm_guided_asr_tpu/models/transformer.py FlashSelfAttention
calls, jax.experimental.pallas.ops.tpu.flash_attention).

On [B, H, T, dk] operands with a frame mask ``valid`` [B, T] (int32, 1 = a
frame, 0 = a pad):

    P[i, j] = softmax_j over the valid keys of (q_i . k_j * sm_scale)
    out_i   = sum_j P[i, j] v_j   for a valid query row, 0 for a pad row

This is the library's SegmentIds semantics (frames in segment 1, pads in
segment 0) followed by the module's zeroing of the pad query rows; the
library's padding of T to a multiple of 128 is a TPU tiling detail and is
not reproduced.  :func:`flash_attention` is an autograd function whose
forward is :func:`flash_attention_fwd` and backward :func:`flash_attention_bwd`
(:func:`flash_attention_bwd_dkv`, then :func:`flash_attention_bwd_dq`): on
CUDA tensors they launch the hand-written kernels of
``csrc/flash_attention.cu``, one entry point each; on CPU tensors
they run :func:`flash_attention_plain`, the dense masked softmax, and
:func:`flash_attention_bwd_plain`, autograd through it.  The backward's
delta = rowsum(out * dout) is a torch reduction, as the library leaves it to
XLA.  The log-sum-exp is float32 [B, H, T], 0 at pad query rows.  Where
one block per query tile would leave the card part idle (B = 1 serving),
the forward kernel splits the keys over :func:`key_splits` blocks, which
write partial results to a float32 workspace that the wrapper allocates,
and merges them in a fixed order, so a repeat call is bitwise equal.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

NEG_INF = -1e30  # masked keys in the plain version (a finite value: an all-pad row stays finite)
HEAD_DIMS = (64, 128, 256)  # the head dims the kernels take (the library's, as the module uses it)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 4 + [_F, _I, _P]  # B, H, T, dk, scale, dtype, stream

KERNEL = CudaKernel(
    "flash_attention.cu",
    {
        "flash_attention_fwd": [_P] * 7 + [_I] + _TAIL,
        "flash_attention_bwd_dkv": [_P] * 9 + _TAIL,
        "flash_attention_bwd_dq": [_P] * 8 + _TAIL,
    },
    error_fn="flash_attention_error_string",
    queries={"flash_attention_fwd_splits": [_I] * 5},
)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _plain_scores(q, k, valid, sm_scale: float) -> torch.Tensor:
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    return scores.masked_fill(~(valid[:, None, None, :] != 0), NEG_INF)


def _plain_out(scores, v, valid) -> torch.Tensor:
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v.float())
    return out.masked_fill(~(valid[:, None, :, None] != 0), 0.0).to(v.dtype)


def flash_attention_plain(q, k, v, valid, sm_scale: float) -> torch.Tensor:
    """Dense reference: the [B, H, T, T] scores in float32, masked keys at
    -1e30, softmax, times v; pad query rows 0; output in the input type."""
    return _plain_out(_plain_scores(q, k, valid, sm_scale), v, valid)


def flash_attention_bwd_plain(q, k, v, valid, dout, sm_scale: float):
    """Autograd through :func:`flash_attention_plain` (the forward
    recomputed): (dq, dk, dv) in the input type."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention_plain(*leaves, valid, sm_scale)
        return torch.autograd.grad(out, leaves, dout)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check(q, k, v, valid):
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, H, T, dk], got {tuple(q.shape)}")
    b, _, t, _ = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(x.shape)} != q {tuple(q.shape)}")
    if tuple(valid.shape) != (b, t):
        raise ValueError(f"flash_attention: valid {tuple(valid.shape)} != {(b, t)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share dtype float32 or bfloat16")
    if valid.dtype != torch.int32:
        raise TypeError(f"flash_attention: valid must be int32, got {valid.dtype}")
    if any(x.device != q.device for x in (k, v, valid)):
        raise ValueError("flash_attention: operands on different devices")


def _check_card(*xs):
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} is not one of {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("flash_attention: operands must be contiguous")


def _tail(q, sm_scale):
    b, h, t, dk = q.shape
    return (b, h, t, dk, float(sm_scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)


def flash_attention_fwd(q, k, v, valid, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with the statistics the backward needs: (out, lse), lse
    [B, H, T] float32 the per-row log-sum-exp over the valid keys (0 at pad
    query rows).  The plain version on CPU tensors, the kernel on CUDA
    tensors."""
    _check(q, k, v, valid)
    return _fwd(q, k, v, valid, sm_scale, True)


def _fwd(q, k, v, valid, sm_scale, want_lse: bool):
    if q.device.type == "cpu":
        scores = _plain_scores(q, k, valid, sm_scale)
        lse = None
        if want_lse:
            lse = torch.logsumexp(scores, dim=-1).masked_fill(~(valid[:, None, :] != 0), 0.0)
        return _plain_out(scores, v, valid), lse
    _check_card(q, k, v, valid)
    _check_aligned("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if want_lse else None
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        splits = key_splits(q)
        # the key splits' partial outputs and (max, sum) pairs, merged by the kernel
        work = (torch.empty(splits * q.shape[:3].numel() * (q.shape[3] + 2), dtype=torch.float32,
                            device=q.device) if splits > 1 else None)
        KERNEL.launch("flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      valid.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
                      None if work is None else work.data_ptr(), splits, *_tail(q, sm_scale),
                      dtype=q.dtype)
    return out, lse


def key_splits(q) -> int:
    """The key splits the forward kernel takes for q's shape on its device
    (a CUDA tensor): more than 1 only where one block per query tile would
    leave the card part idle."""
    return _key_splits(q.device.index, *q.shape, _DTYPE_CODE[q.dtype])


@functools.lru_cache(maxsize=1024)
def _key_splits(device_index, b, h, t, dk, dtype_code) -> int:
    with torch.cuda.device(device_index):
        n = KERNEL.query("flash_attention_fwd_splits", b, h, t, dk, dtype_code)
    if n < 1:
        raise RuntimeError(f"flash_attention_fwd_splits failed: CUDA error {-n}")
    return n


def _check_aligned(name, *xs):
    if any(x.data_ptr() % 16 for x in xs):  # the kernels copy 16-byte chunks
        raise ValueError(f"{name}: the [B, H, T, dk] operands must be 16-byte aligned")


def _check_bwd(q, k, v, valid, dout, lse, delta):
    _check_card(q, k, v, valid, dout, lse, delta)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: dout must match q in shape and dtype")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: {name} must be float32 {tuple(q.shape[:3])}")
    _check_aligned("flash_attention_bwd", q, k, v, dout)


def flash_attention_bwd_dkv(q, k, v, valid, dout, lse, delta, sm_scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) for the output gradient ``dout``, given the forward's
    ``lse`` and delta = rowsum(out * dout), both float32 [B, H, T].  On CPU
    tensors the plain backward's (lse and delta unused); on CUDA tensors the
    ``flash_attention_bwd_dkv`` kernel."""
    _check(q, k, v, valid)
    if q.device.type == "cpu":
        return tuple(flash_attention_bwd_plain(q, k, v, valid, dout, sm_scale)[1:])
    _check_bwd(q, k, v, valid, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        with torch.cuda.device(q.device):
            KERNEL.launch("flash_attention_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          valid.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dk.data_ptr(), dv.data_ptr(), *_tail(q, sm_scale), dtype=q.dtype)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, valid, dout, lse, delta, sm_scale: float) -> torch.Tensor:
    """dq for the output gradient ``dout``, from the same ``lse`` and
    ``delta``.  On CPU tensors the plain backward's; on CUDA tensors the
    ``flash_attention_bwd_dq`` kernel."""
    _check(q, k, v, valid)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, valid, dout, sm_scale)[0]
    _check_bwd(q, k, v, valid, dout, lse, delta)
    dq = torch.empty_like(q)
    if q.numel():
        with torch.cuda.device(q.device):
            KERNEL.launch("flash_attention_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          valid.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), *_tail(q, sm_scale), dtype=q.dtype)
    return dq


def flash_attention_bwd(q, k, v, valid, out, lse, dout, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_attention` for the output
    gradient ``dout``, given the forward's ``out`` and ``lse``, in the input
    type.  On CPU tensors this is :func:`flash_attention_bwd_plain` (out and
    lse unused); on CUDA tensors delta = rowsum(out * dout) in float32, then
    the dK/dV kernel and the dQ kernel."""
    _check(q, k, v, valid)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, valid, dout, sm_scale)
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out must match q in shape and dtype")
    delta = (out.float() * dout.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, valid, dout, lse, delta, sm_scale)
    return flash_attention_bwd_dq(q, k, v, valid, dout, lse, delta, sm_scale), dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """Autograd around the forward and :func:`flash_attention_bwd`: the
    forward saves its output and the per-row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, valid, sm_scale):
        out, lse = _fwd(q, k, v, valid, sm_scale, True)
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, valid, out, lse, dout.contiguous(),
                                         ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, valid, sm_scale: float) -> torch.Tensor:
    """Flash self-attention; see the module docstring for the contract.

    On the card, a call that needs no gradient launches the forward only and
    stores no statistics; on the CPU the same two paths run the plain
    versions."""
    _check(q, k, v, valid)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, valid, sm_scale)
    return _fwd(q, k, v, valid, sm_scale, False)[0]

