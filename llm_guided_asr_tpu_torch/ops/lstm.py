"""The LSTM recurrence of the transducer's prediction network and of the LSTM LM.

The JAX package runs flax's ``nn.RNN`` over ``OptimizedLSTMCell``, a
``lax.scan`` (llm_guided_asr_tpu/models/transducer.py:104 ``RNNDecoder``,
models/lm.py), not a Pallas kernel.  Per batch row, from h = c = 0, with
the input projections ``xi`` = x W_ih^T [B, L, 4H] taken outside by one
GEMM and the gates in flax's order (i, f, g, o):

    a_t = (h_{t-1} W_hh^T + bias) + xi_t
    c_t = sigmoid(a_f) c_{t-1} + sigmoid(a_i) tanh(a_g)
    h_t = sigmoid(a_o) tanh(c_t)

:func:`lstm_recurrence_plain` is the plain version (a Python loop over L,
flax's association), which CPU tensors run.  On CUDA tensors
:func:`lstm_fwd` and :func:`lstm_bwd` launch the hand-written kernels of
``csrc/lstm.cu``: one persistent, cooperatively launched grid runs the
whole sequence (cuDNN would launch a GEMM and a cell kernel per
position).  :func:`lstm_recurrence` is the differentiable front door: the
kernels' autograd function on the card (the backward kernel gives the
pre-activation gradient da = d xi; the weight gradients are GEMMs of da
with the inputs), the plain loop under autograd on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "lstm.cu",
    {
        "lstm_fwd": [_P] * 8 + [_I] * 3 + [_P],
        "lstm_bwd": [_P] * 6 + [_I] * 3 + [_P],
    },
    error_fn="lstm_error_string",
    queries={"lstm_max_rows": [_I] * 3},
)

# the dynamic shared memory a launch may take; a larger batch is cut into
# launches of fewer rows
SMEM_LIMIT = 200 * 1024


def lstm_recurrence_plain(xi: torch.Tensor, w_hh: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """xi [B, L, 4H], w_hh [4H, H], bias [4H] -> h [B, L, H]: the loop over
    L, differentiable by autograd."""
    b, length, g4 = xi.shape
    h = c = xi.new_zeros(b, g4 // 4)
    out = []
    for t in range(length):
        i, f, g, o = ((h @ w_hh.t() + bias) + xi[:, t]).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1) if out else xi.new_zeros(b, 0, g4 // 4)


def _check(xi, w_hh, bias) -> None:
    if xi.dim() != 3 or xi.shape[2] % 4 or w_hh.shape != (xi.shape[2], xi.shape[2] // 4) \
            or bias.shape != (xi.shape[2],):
        raise ValueError(f"lstm: bad shapes xi{tuple(xi.shape)} w_hh{tuple(w_hh.shape)} "
                         f"bias{tuple(bias.shape)}")
    if len({x.device for x in (xi, w_hh, bias)}) != 1:
        raise ValueError("lstm: inputs on different devices")
    if xi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm: unsupported device {xi.device}")


def _check_card(*xs) -> None:
    for x in xs:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("lstm: the kernels take contiguous float32 tensors")


def _row_chunks(b: int, hidden: int, device: torch.device, backward: bool):
    """Row ranges of at most the rows one launch's shared memory holds."""
    rows = max_rows(hidden, device.index, backward)
    return [(r, min(b, r + rows)) for r in range(0, b, rows)]


@functools.lru_cache(maxsize=256)
def max_rows(hidden: int, device_index: Optional[int], backward: bool = False) -> int:
    """The most batch rows one launch of the forward (or the backward)
    kernel takes at hidden width ``hidden``."""
    with torch.cuda.device(device_index):
        rows = KERNEL.query("lstm_max_rows", hidden, SMEM_LIMIT, int(backward))
    if rows < 1:
        raise ValueError(f"lstm: hidden width {hidden} does not fit the kernels")
    return rows


def lstm_fwd(xi: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor,
             save: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                         Optional[torch.Tensor]]:
    """(h [B, L, H], gates [B, L, 4H], cells [B, L, H]): the plain loop on
    CPU tensors (no gates or cells), the kernel ``lstm_fwd`` on CUDA
    tensors, which also keeps the gate activations and cell states for
    the backward when ``save``."""
    _check(xi, w_hh, bias)
    if xi.device.type == "cpu":
        return lstm_recurrence_plain(xi, w_hh, bias), None, None
    _check_card(xi, w_hh, bias)
    b, length, g4 = xi.shape
    hidden = g4 // 4
    y = xi.new_empty(b, length, hidden)
    gates = xi.new_empty(b, length, g4) if save else None
    cells = xi.new_empty(b, length, hidden) if save else None
    if b * length == 0:
        return y, gates, cells
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0, r1 in _row_chunks(b, hidden, xi.device, False):
            n = r1 - r0
            hbuf = xi.new_empty(2 * n * hidden)
            bar = torch.zeros(2, dtype=torch.int32, device=xi.device)
            KERNEL.launch("lstm_fwd", xi[r0:r1].data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
                          y[r0:r1].data_ptr(), gates[r0:r1].data_ptr() if save else None,
                          cells[r0:r1].data_ptr() if save else None, hbuf.data_ptr(),
                          bar.data_ptr(), n, length, hidden, stream)
    return y, gates, cells


def lstm_bwd(dy: torch.Tensor, gates: torch.Tensor, cells: torch.Tensor,
             w_hh: torch.Tensor) -> torch.Tensor:
    """da [B, L, 4H], the gradient of the pre-activations a_t (= the
    gradient of xi), from the output gradient dy [B, L, H] and the
    forward's saved gates and cells: the kernel ``lstm_bwd`` (CUDA tensors
    only; the CPU differentiates the plain loop)."""
    if dy.device.type != "cuda":
        raise ValueError(f"lstm_bwd: the kernel takes CUDA tensors, got {dy.device}")
    b, length, hidden = dy.shape
    if gates.shape != (b, length, 4 * hidden) or cells.shape != dy.shape \
            or w_hh.shape != (4 * hidden, hidden):
        raise ValueError("lstm_bwd: dy, gates, cells and w_hh disagree in shape")
    if len({x.device for x in (dy, gates, cells, w_hh)}) != 1:
        raise ValueError("lstm_bwd: inputs on different devices")
    _check_card(dy, gates, cells, w_hh)
    da = dy.new_empty(b, length, 4 * hidden)
    if b * length == 0:
        return da
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0, r1 in _row_chunks(b, hidden, dy.device, True):
            bar = torch.zeros(2, dtype=torch.int32, device=dy.device)
            KERNEL.launch("lstm_bwd", dy[r0:r1].data_ptr(), gates[r0:r1].data_ptr(),
                          cells[r0:r1].data_ptr(), w_hh.data_ptr(), da[r0:r1].data_ptr(),
                          bar.data_ptr(), r1 - r0, length, hidden, stream)
    return da


class _LSTMFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xi, w_hh, bias):
        y, gates, cells = lstm_fwd(xi, w_hh, bias, save=True)
        ctx.save_for_backward(w_hh, y, gates, cells)
        return y

    @staticmethod
    def backward(ctx, dy):
        w_hh, y, gates, cells = ctx.saved_tensors
        da = lstm_bwd(dy.contiguous(), gates, cells, w_hh)
        h_prev = torch.cat([y.new_zeros(y.shape[0], 1, y.shape[2]), y[:, :-1]], dim=1)
        d_w = da.reshape(-1, da.shape[2]).t() @ h_prev.reshape(-1, h_prev.shape[2])
        return da, d_w, da.sum(dim=(0, 1))


def lstm_recurrence(xi: torch.Tensor, w_hh: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """h [B, L, H] of the recurrence from the zero state; differentiable in
    xi, w_hh and bias.  A call that needs no gradient runs the forward
    kernel alone (on the card), without saving gates and cells."""
    _check(xi, w_hh, bias)
    if xi.device.type == "cpu":
        return lstm_recurrence_plain(xi, w_hh, bias)
    xi, w_hh, bias = xi.contiguous(), w_hh.contiguous(), bias.contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (xi, w_hh, bias)):
        return _LSTMFn.apply(xi, w_hh, bias)
    return lstm_fwd(xi, w_hh, bias)[0]
