"""Relative-position self-attention (counterpart of llm_guided_asr_tpu/ops/rel_attention.py).

Transformer-XL scoring over [B, H, T, dk] operands with the dense position
table p [H, 2T-1, dk] (row T-1 is relative position 0):

    s[i, j] = qu_i . k_j + qv_i . p_{(T-1)-i+j}
    P       = softmax_j(mask(s[i, :]) * sm_scale)
    out_i   = sum_j keep_ij / (1 - rate) * P[i, j] v_j

``keep`` is :func:`dropout_keep_mask`, the TPU kernel's counter hash of
(seed, head, batch, i, j), bit for bit; with ``dropout_rate`` 0 every
probability is kept.  :func:`rel_attention` is an autograd function whose
forward is :func:`rel_attention_fwd` and backward :func:`rel_attention_bwd`:
on CUDA tensors they launch the hand-written kernels of
``csrc/rel_attention.cu``; on CPU tensors they run
:func:`rel_attention_plain`, the dense einsum with the pad-reshape
rel-shift, and :func:`rel_attention_bwd_plain`, autograd through it.  Masked keys score -1e30 in
both, as in the TPU kernel; a row with at least one valid key is exact.

bfloat16 operands (a bfloat16 model's): the kernels and the plain version
read them exactly, compute every score, probability and gradient in
float32 and round only their outputs (out, dqu, dqv, dk, dv) to bfloat16;
dp is summed in float32 and rounded once, where the autograd function
returns it in p's type.  Both keep more precision than the TPU kernel,
which rounds the unnormalized probabilities to bfloat16 before P.V and
the backward's dS and unshifted dBD before their products
(llm_guided_asr_tpu/ops/rel_attention.py:86-100, 183-187, 256).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DK = 128
_U32 = 0xFFFFFFFF
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DROPOUT_ARGS = [_F, _I, ctypes.c_uint, _F, _I, _P]  # scale, seed, threshold, inv_keep, dtype, stream

KERNEL = CudaKernel(
    "rel_attention.cu",
    {
        "rel_attention_fwd": [_P] * 9 + [_I] * 5 + _DROPOUT_ARGS,
        "rel_attention_bwd": [_P] * 16 + [_I] * 4 + _DROPOUT_ARGS,
    },
    error_fn="rel_attention_error_string",
    queries={"rel_attention_fwd_splits": [_I] * 5, "rel_attention_bwd_workspace": [_I] * 5},
)


# ---------------------------------------------------------------------------
# dropout hash
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x, c < 2**32, in int64 without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def dropout_threshold(rate: float) -> int:
    """uint32(rate * 2**32), as the TPU kernel computes it (f64, truncated)."""
    return min(int(min(rate, 1.0) * 4294967296.0), _U32)


def dropout_keep_mask(seed, head, batch, rows: int, cols: int, rate: float,
                      device=None) -> torch.Tensor:
    """The TPU kernel's keep mask (True = keep), P(keep) = 1 - rate.

    A stateless xorshift-multiply hash of (seed, head, batch, row, col) in
    uint32 arithmetic, done here in int64 with a 32-bit wrap after every
    multiply and add.  ``seed`` is the int32 seed reinterpreted as uint32;
    ``head`` and ``batch`` are ints or int tensors that broadcast together
    (the result is [*broadcast, rows, cols]).
    """
    h = torch.as_tensor(head, dtype=torch.int64, device=device)
    b = torch.as_tensor(batch, dtype=torch.int64, device=device)
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    x = (_mul32(r, 0x9E3779B1) + _mul32(c, 0x85EBCA77)) & _U32
    cell = ((int(seed) & _U32) + _mul32(h, 0x927C1) + _mul32(b, 0x68E31DA5)) & _U32
    x = x ^ cell[..., None, None]
    x = _mul32(x ^ (x >> 15), 0x2C1B3C6D)
    x = _mul32(x ^ (x >> 12), 0x297A2D39)
    x = x ^ (x >> 15)
    return x >= dropout_threshold(rate)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rel_shift(x: torch.Tensor, t: int) -> torch.Tensor:
    """[B, H, T, 2T-1] -> [B, H, T, T]: out[i, j] = x[i, (T-1) - i + j]
    (espnet attention.py rel_shift, zero_triu=False)."""
    b, h, _, p = x.shape
    x = torch.nn.functional.pad(x, (1, 0))
    x = x.reshape(b, h, p + 1, t)[:, :, 1:]
    return x.reshape(b, h, t, p)[..., :t]


def _plain_scores(qu, qv, k, p, kv_valid, sm_scale: float) -> torch.Tensor:
    """Masked, scaled scores [B, H, T, T] in float32, through the dense
    [B, H, T, 2T-1] position scores and the rel-shift."""
    t = qu.shape[2]
    ac = torch.einsum("bhqd,bhkd->bhqk", qu.float(), k.float())
    bd = rel_shift(torch.einsum("bhqd,hpd->bhqp", qv.float(), p.float()), t)
    scores = (ac + bd) * sm_scale
    return scores.masked_fill(~(kv_valid[:, None, None, :] != 0), NEG_INF)


def _plain_attend(scores, v, seed, dropout_rate: float) -> torch.Tensor:
    """Softmax of the scores, the hash mask with dropout, times v."""
    b, h, t, _ = scores.shape
    attn = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed, torch.arange(h)[None, :], torch.arange(b)[:, None],
                                 t, t, dropout_rate, device=v.device)
        attn = torch.where(keep, attn, 0.0) / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v.float()).to(v.dtype)


def rel_attention_plain(qu, qv, k, v, p, kv_valid, sm_scale: float, seed=None,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Dense reference: materialises the [B, H, T, 2T-1] position scores and
    rel-shifts them; float32 throughout, output in the input type.  With
    dropout the hash mask is applied to the probabilities."""
    return _plain_attend(_plain_scores(qu, qv, k, p, kv_valid, sm_scale), v, seed, dropout_rate)


def rel_attention_bwd_plain(qu, qv, k, v, p, kv_valid, dout, sm_scale: float, seed=None,
                            dropout_rate: float = 0.0):
    """Autograd through :func:`rel_attention_plain` (the forward recomputed):
    (dqu, dqv, dk, dv) in the input type and dp in float32."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (qu, qv, k, v, p)]
        out = rel_attention_plain(*leaves, kv_valid, sm_scale, seed, dropout_rate)
        grads = torch.autograd.grad(out, leaves, dout)
    return (*grads[:4], grads[4].float())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check(qu, qv, k, v, p, kv_valid, seed, dropout_rate):
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
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"rel_attention: dropout_rate {dropout_rate} not in [0, 1)")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("rel_attention: dropout needs an int32 seed")


def _check_card(*xs):
    qu = xs[0]
    if qu.device.type != "cuda":
        raise ValueError(f"rel_attention: unsupported device {qu.device}")
    if qu.shape[-1] > MAX_DK:
        raise ValueError(f"rel_attention: head dim {qu.shape[-1]} > {MAX_DK} is not supported "
                         "by the kernel")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("rel_attention: operands must be contiguous")


def _dropout_args(sm_scale, seed, dropout_rate, dtype):
    seed32 = 0 if seed is None else int(seed)
    if not -2**31 <= seed32 < 2**31:
        raise ValueError(f"rel_attention: seed {seed32} is not an int32")
    inv_keep = 1.0 / (1.0 - dropout_rate)
    return (float(sm_scale), seed32, dropout_threshold(dropout_rate) if dropout_rate > 0 else 0,
            inv_keep, _DTYPE_CODE[dtype], torch.cuda.current_stream().cuda_stream)


def rel_attention_fwd(qu, qv, k, v, p, kv_valid, sm_scale: float, seed=None,
                      dropout_rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with the statistics the backward needs: (out, lse), lse
    [B, H, T] float32 the per-row log-sum-exp of the pre-dropout softmax.
    The plain version on CPU tensors, the kernel on CUDA tensors."""
    _check(qu, qv, k, v, p, kv_valid, seed, dropout_rate)
    return _fwd(qu, qv, k, v, p, kv_valid, sm_scale, seed, dropout_rate, True)


def _fwd(qu, qv, k, v, p, kv_valid, sm_scale, seed, dropout_rate, want_lse: bool):
    if qu.device.type == "cpu":
        scores = _plain_scores(qu, qv, k, p, kv_valid, sm_scale)
        lse = torch.logsumexp(scores, dim=-1) if want_lse else None
        return _plain_attend(scores, v, seed, dropout_rate), lse
    _check_card(qu, qv, k, v, p, kv_valid)
    b, h, t, dk = qu.shape
    out = torch.empty_like(qu)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=qu.device) if want_lse else None
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(qu.device):
        splits = key_splits(qu)
        # the key splits' partial outputs and (max, sum) pairs, merged by the kernel
        work = (torch.empty(splits * b * h * t * (dk + 2), dtype=torch.float32, device=qu.device)
                if splits > 1 else None)
        KERNEL.launch("rel_attention_fwd", qu.data_ptr(), qv.data_ptr(), k.data_ptr(),
                      v.data_ptr(), p.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      None if work is None else work.data_ptr(), splits, b, h, t, dk,
                      *_dropout_args(sm_scale, seed, dropout_rate, qu.dtype), dtype=qu.dtype)
    return out, lse


def key_splits(qu) -> int:
    """The key splits the forward kernel takes for qu's shape on its device
    (a CUDA tensor): more than 1 only where one block per query tile would
    leave the card part idle."""
    return _query("rel_attention_fwd_splits", qu.device.index, *qu.shape,
                  _DTYPE_CODE[qu.dtype])


@functools.lru_cache(maxsize=1024)
def _query(name, device_index, b, h, t, dk, dtype_code) -> int:
    with torch.cuda.device(device_index):
        n = KERNEL.query(name, b, h, t, dk, dtype_code)
    if n < 1:
        raise RuntimeError(f"{name} refused the shape {(b, h, t, dk)} (returned {n})")
    return n


def rel_attention_bwd(qu, qv, k, v, p, kv_valid, out, lse, dout, sm_scale: float, seed=None,
                      dropout_rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Gradients (dqu, dqv, dk, dv, dp) of :func:`rel_attention` for the
    output gradient ``dout``, given the forward's ``out`` and per-row
    log-sum-exp ``lse`` [B, H, T] (float32).  dqu, dqv, dk, dv come back in
    the input type, dp [H, 2T-1, dk] in float32, summed over the batch.
    On CPU tensors this is :func:`rel_attention_bwd_plain` (out and lse
    unused); on CUDA tensors the kernel."""
    _check(qu, qv, k, v, p, kv_valid, seed, dropout_rate)
    if qu.device.type == "cpu":
        return rel_attention_bwd_plain(qu, qv, k, v, p, kv_valid, dout, sm_scale, seed,
                                       dropout_rate)
    _check_card(qu, qv, k, v, p, kv_valid, out, lse, dout)
    b, h, t, dk = qu.shape
    if out.shape != qu.shape or dout.shape != qu.shape or out.dtype != qu.dtype \
            or dout.dtype != qu.dtype:
        raise ValueError("rel_attention_bwd: out and dout must match qu in shape and dtype")
    if tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"rel_attention_bwd: lse must be float32 {(b, h, t)}")
    grads = [torch.empty_like(x) for x in (qu, qv, k, v)]
    dp = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if qu.numel() == 0:
        return (*grads, dp)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=qu.device)
    with torch.cuda.device(qu.device):
        # float32 dp partials of every (batch row, head, key tile), summed in a fixed order
        work = torch.empty(_query("rel_attention_bwd_workspace", qu.device.index, b, h, t, dk,
                                  _DTYPE_CODE[qu.dtype]),
                           dtype=torch.float32, device=qu.device)
        KERNEL.launch("rel_attention_bwd", qu.data_ptr(), qv.data_ptr(), k.data_ptr(),
                      v.data_ptr(), p.data_ptr(), kv_valid.data_ptr(), out.data_ptr(),
                      lse.data_ptr(), dout.data_ptr(), delta.data_ptr(),
                      *(g.data_ptr() for g in grads), dp.data_ptr(), work.data_ptr(), b, h, t,
                      dk, *_dropout_args(sm_scale, seed, dropout_rate, qu.dtype), dtype=qu.dtype)
    return (*grads, dp)


class _RelAttentionFn(torch.autograd.Function):
    """Autograd around the forward and :func:`rel_attention_bwd`: the
    forward saves its output and the per-row log-sum-exp."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, p, kv_valid, sm_scale, seed, dropout_rate):
        out, lse = _fwd(qu, qv, k, v, p, kv_valid, sm_scale, seed, dropout_rate, True)
        ctx.save_for_backward(qu, qv, k, v, p, kv_valid, out, lse)
        ctx.args = (sm_scale, seed, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        qu, qv, k, v, p, kv_valid, out, lse = ctx.saved_tensors
        sm_scale, seed, dropout_rate = ctx.args
        dqu, dqv, dk, dv, dp = rel_attention_bwd(qu, qv, k, v, p, kv_valid, out, lse,
                                                 dout.contiguous(), sm_scale, seed, dropout_rate)
        return dqu, dqv, dk, dv, dp.to(p.dtype), None, None, None, None


def rel_attention(qu, qv, k, v, p, kv_valid, sm_scale: float, seed: Optional[int] = None,
                  dropout_rate: float = 0.0) -> torch.Tensor:
    """Fused rel-pos attention; see the module docstring for the contract.

    ``seed`` (an int32) keys the dropout hash and is needed when
    ``dropout_rate`` > 0.  On the card, a call that needs no gradient
    launches the forward only and stores no statistics; on the CPU the same
    two paths run the plain versions."""
    _check(qu, qv, k, v, p, kv_valid, seed, dropout_rate)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qu, qv, k, v, p)):
        return _RelAttentionFn.apply(qu, qv, k, v, p, kv_valid, sm_scale, seed, dropout_rate)
    return _fwd(qu, qv, k, v, p, kv_valid, sm_scale, seed, dropout_rate, False)[0]
