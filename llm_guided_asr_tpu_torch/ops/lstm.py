"""The LSTM recurrence of the transducer's prediction network, the LSTM LM
and the (VGG-)RNN encoders.

The JAX package runs flax's ``nn.RNN`` over ``OptimizedLSTMCell``, a
``lax.scan`` (llm_guided_asr_tpu/models/transducer.py:104 ``RNNDecoder``,
models/lm.py, models/extra_encoders.py), not a Pallas kernel.  Per batch
row, from h = c = 0, with the input projections ``xi`` = x W_ih^T
[B, L, 4H] taken outside by one GEMM and the gates in flax's order
(i, f, g, o):

    a_t = (h_{t-1} W_hh^T + bias) + xi_t
    c_t = sigmoid(a_f) c_{t-1} + sigmoid(a_i) tanh(a_g)
    h_t = sigmoid(a_o) tanh(c_t)

:func:`lstm_recurrence_plain` is the plain version (a Python loop over L,
flax's association), which CPU tensors run.  On CUDA tensors
:func:`lstm_fwd` and :func:`lstm_bwd` launch the hand-written kernels of
``csrc/lstm.cu``, one launch a call for the whole batch and sequence: the
batch is cut into row groups of 8 (16 where more groups than the card
holds at once would run in waves), each group a thread-block cluster of up
to 16 CTAs; each CTA owns a slice of the hidden units and their rows of
W_hh, runs each step's product on the tensor cores in 3xTF32, and passes
h (forward) or its partials of W_hh^T da (backward) to the cluster's
other CTAs through distributed shared memory; the cluster's barrier
separates the steps.  :func:`launch_plan` is that plan (row groups,
cluster size, units a CTA, shared memory), a pure function of the shape.

Where W_hh lives is chosen by H alone: up to ``RESIDENT_MAX_HIDDEN`` =
320 units (the transducer's 256, the RNN encoders' 320) each CTA keeps its
slice in shared memory for the whole sequence; wider (ESPnet's LSTM LM at
650, 1024) each CTA reads its slice from L2 every step.

:func:`lstm_recurrence` is the differentiable front door: the kernels'
autograd function on the card (the backward kernel gives the
pre-activation gradient da = d xi; the weight gradients are GEMMs of da
with the inputs), the plain loop under autograd on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "lstm.cu",
    {
        "lstm_fwd": [_P] * 6 + [_I] * 9 + [_P],
        "lstm_bwd": [_P] * 5 + [_I] * 8 + [_P],
    },
    error_fn="lstm_error_string",
    queries={"lstm_max_active_clusters": [_I] * 8},
)

# The widest W_hh kept in shared memory; wider ones are read from L2 every step.
RESIDENT_MAX_HIDDEN = 320
MAX_CLUSTER = 16  # CTAs a cluster (non-portable above 8)
WARPS = 16  # a CTA's warps (csrc/lstm.cu)
TILE_ROWS = 8  # batch rows an mma tile (n = 8)
STAGED = 7  # backward inputs a (row, unit) a step: dy, 4 gates, c_t, c_{t-1}
SMEM_MAX = 232_448  # the dynamic shared memory an H100 block can take


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _ld16(n: int) -> int:
    """A row stride of at least n floats, 16 more than a multiple of 32."""
    r = _round16(n)
    return r if r % 32 == 16 else r + 16


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of ``lstm_fwd`` or ``lstm_bwd``: ``groups`` clusters of
    ``cluster`` CTAs, each cluster ``rows`` batch rows, each CTA ``units``
    hidden units (4 ``units`` gate rows of W_hh) and the step product cut
    into ``k_chunks`` per tile of 16 gate rows (the forward's)."""

    batch: int
    hidden: int
    backward: bool
    streamed: bool
    cluster: int
    units: int
    n_tiles: int
    k_chunks: int

    @property
    def rows(self) -> int:
        return TILE_ROWS * self.n_tiles

    @property
    def groups(self) -> int:
        return -(-self.batch // self.rows)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a CTA: the buffers laid out at the top of
        ``lstm_fwd_kernel`` and ``lstm_bwd_kernel`` (csrc/lstm.cu), which
        take this size from the launch."""
        r, g4, u = self.rows, 4 * self.units, self.units
        w = 0 if self.streamed else 1
        if self.backward:
            ldt = _ld16(g4)
            floats = (w * _round16(self.hidden) * ldt + 2 * r * ldt
                      + 2 * self.cluster * u * (r + 2) + 3 * STAGED * r * u + r * u)
        else:
            ld = _ld16(self.hidden)
            floats = (w * g4 * ld + 2 * r * ld + g4
                      + self.k_chunks * r * (g4 + 4) + 3 * r * g4 + r * u)
        return 4 * floats


def cluster_shape(hidden: int) -> Tuple[int, int]:
    """(CTAs a cluster, hidden units a CTA): 16 CTAs from 64 units up, else
    the largest power of two with at least 4 units a CTA; units a multiple
    of 4 (a tile of 16 gate rows), the last CTAs' slices part or all past
    ``hidden``."""
    cluster = MAX_CLUSTER if hidden >= 4 * MAX_CLUSTER else \
        1 << (max(1, hidden // 4).bit_length() - 1)
    return cluster, 4 * -(-hidden // (4 * cluster))


def launch_plan(batch: int, hidden: int, backward: bool, max_clusters: int) -> LaunchPlan:
    """The launch of a [batch, ·, hidden] recurrence on a card that holds
    ``max_clusters`` clusters of one tile at once: two tiles (16 rows) a
    cluster where one would leave groups waiting for a second wave and two
    fit the shared memory."""
    if batch < 1 or hidden < 1 or max_clusters < 1:
        raise ValueError(f"lstm: no launch for batch {batch}, hidden {hidden}, "
                         f"{max_clusters} clusters at once")
    cluster, units = cluster_shape(hidden)
    k_blocks = _round16(hidden) // 16
    k_chunks = 1 if backward else max(1, min(WARPS // (units // 4), k_blocks))
    plans = [LaunchPlan(batch, hidden, backward, hidden > RESIDENT_MAX_HIDDEN, cluster, units,
                        n_tiles, k_chunks) for n_tiles in (1, 2)]
    plan = plans[0]
    if -(-batch // TILE_ROWS) > max_clusters and plans[1].smem_bytes <= SMEM_MAX:
        plan = plans[1]
    if plan.smem_bytes > SMEM_MAX:
        raise ValueError(f"lstm: hidden width {hidden} does not fit the kernels "
                         f"({plan.smem_bytes} bytes of shared memory a CTA)")
    return plan


@functools.lru_cache(maxsize=256)
def max_active_clusters(hidden: int, backward: bool, device_index: Optional[int]) -> int:
    """Clusters of one tile the card holds at once for this width (the
    kernels' occupancy query); raises if none fits."""
    p = launch_plan(1, hidden, backward, 1)
    with torch.cuda.device(device_index):
        n = KERNEL.query("lstm_max_active_clusters", int(backward), hidden, p.cluster, p.units,
                         1, p.k_chunks, int(p.streamed), p.smem_bytes)
    if n < 0:
        raise RuntimeError(f"lstm: the occupancy query failed: CUDA error {-n}")
    if n == 0:
        raise RuntimeError(f"lstm: no cluster of {p.cluster} CTAs with {p.smem_bytes} bytes "
                           f"of shared memory fits the card (hidden {hidden})")
    return n


def plan_for(batch: int, hidden: int, backward: bool, device: torch.device) -> LaunchPlan:
    """:func:`launch_plan` on ``device``."""
    return launch_plan(batch, hidden, backward,
                       max_active_clusters(hidden, backward, device.index))


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
    p = plan_for(b, hidden, False, xi.device)
    with torch.cuda.device(xi.device):
        KERNEL.launch("lstm_fwd", xi.data_ptr(), w_hh.data_ptr(), bias.data_ptr(), y.data_ptr(),
                      gates.data_ptr() if save else None, cells.data_ptr() if save else None,
                      b, length, hidden, p.cluster, p.units, p.n_tiles, p.k_chunks,
                      int(p.streamed), p.smem_bytes, torch.cuda.current_stream().cuda_stream,
                      dtype=xi.dtype)
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
    p = plan_for(b, hidden, True, dy.device)
    with torch.cuda.device(dy.device):
        KERNEL.launch("lstm_bwd", dy.data_ptr(), gates.data_ptr(), cells.data_ptr(),
                      w_hh.data_ptr(), da.data_ptr(), b, length, hidden, p.cluster, p.units,
                      p.n_tiles, int(p.streamed), p.smem_bytes,
                      torch.cuda.current_stream().cuda_stream, dtype=dy.dtype)
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
