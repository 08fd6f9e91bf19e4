"""Compositional state-space sequence model and the S4 encoder
(counterpart of llm_guided_asr_tpu/models/state_spaces.py).

ESPnet's ``encoder: s4`` (espnet2/asr/state_spaces/{model,block,residual,
pool}.py): the input layer (``conv2d`` x4 subsampling or a Dense), then a
``SequenceModel`` trunk of ``num_blocks`` groups; a group runs one
``SequenceResidualBlock`` per entry of ``ss_layers`` (``s4`` NPLR, ``s4d``
diagonal, ``ff`` feed-forward, ``mha`` self-attention), each a norm (pre
or post, ``ss_norm``: LayerNorm at flax's eps 1e-6, the masked batch norm,
or none), the layer, dropout, stochastic depth (``ss_drop_path``, one draw
a row) and a residual function (``ss_residual``), and every group but the
last pools time by ``ss_pool_stride`` (``ss_pool``: sample, avg or
linear), the lengths with it; then ``final_norm``.

The SSM cores convolve by FFT as models/s4_decoder.py does (whose NPLR
kernel they use); ``ss_bidirectional`` adds an anticausal kernel that
convolves the reversed sequence.  Pads are zeroed before every layer but
``mha``, which masks its keys instead.  Module names are flax's, the
auto-named layers included (``S4Core_0``, ``S4DCore_0``, ``FFLayer_0``,
``MHALayer_0``).

Compute dtype: the trunk's input's (the model casts the features).  The
FFT convolutions run in float32 and their output is cast to the compute
dtype; ``+ D u`` promotes to float32 through the float32 ``d`` until
``out_proj`` casts back (JAX models/state_spaces.py:46-53, 104-109,
169-174).  The ``affine`` residual multiplies by a float32 parameter and
so carries the residual stream in float32, as JAX promotes it; every norm
returns the compute dtype (flax's ``dtype``) and every layer reads it.
One difference: under ``ss_norm: none`` with the ``affine`` residual JAX
hands the float32 stream to the next layer, which the port rounds first.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import (
    ConformerConfig,
    MaskedBatchNorm,
    embed_features,
    gelu_tanh,
    input_layer,
    refuse_no_input_layer,
)
from llm_guided_asr_tpu_torch.models.s4_decoder import (
    complex_pair,
    fft_causal_conv,
    init_nplr,
    nplr_dplr,
    s4_nplr_kernel,
    s4d_init,
    s4d_kernel,
)
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    MultiHeadedAttention,
    sigmoid,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


def causal_or_bidi_conv(u: torch.Tensor, kern_fwd: torch.Tensor,
                        kern_bwd: Optional[torch.Tensor]) -> torch.Tensor:
    """u [B, L, H] convolved causally with kern_fwd [H, L], plus
    anticausally with kern_bwd (the reversed sequence convolved, then
    reversed back) when given."""
    y = fft_causal_conv(u, kern_fwd)
    if kern_bwd is not None:
        y = y + fft_causal_conv(u.flip(1), kern_bwd).flip(1)
    return y


class _SSMCore(nn.Module):
    """The part S4DCore and S4Core share: the kernels [copies, H, L] of
    ``kernels``, the FFT convolution, + D u, tanh GELU, dropout,
    ``out_proj``."""

    def __init__(self, d_model: int, bidirectional: bool, dropout_rate: float):
        super().__init__()
        self.bidirectional = bidirectional
        self.dropout_rate = dropout_rate
        self.log_dt = nn.Parameter(torch.zeros(d_model))
        self.d = nn.Parameter(torch.ones(d_model))
        self.out_proj = Dense(d_model, d_model)

    def forward(self, u, rng: Optional[StepRNG] = None):
        kerns = self.kernels(u.shape[1])
        y = causal_or_bidi_conv(u, kerns[0], kerns[1] if self.bidirectional else None)
        y = gelu_tanh(y.to(u.dtype) + u * self.d)  # float32 (at least) through d
        y = dropout(y, active_rate(self, self.dropout_rate), rng)
        return self.out_proj(y, u.dtype)


class S4DCore(_SSMCore):
    """Diagonal SSM core (SSKernelDiag): ``log_a_re``, ``a_im`` [copies, H,
    N/2], ``c`` [copies, H, N/2, 2]."""

    def __init__(self, d_model: int, d_state: int = 64, bidirectional: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__(d_model, bidirectional, dropout_rate)
        copies, n = 2 if bidirectional else 1, d_state // 2
        s4d_init(self, (copies, d_model, n))
        self.c = nn.Parameter(torch.zeros(copies, d_model, n, 2))

    def kernels(self, length: int) -> torch.Tensor:
        return s4d_kernel(self.log_dt, self.log_a_re, self.a_im, self.c, length)


class S4Core(_SSMCore):
    """NPLR S4 core (HiPPO-LegS, the Cauchy/Woodbury kernel): Lambda, P, B
    shared by the copies, ``c`` [copies, H, N, 2]."""

    def __init__(self, d_model: int, d_state: int = 64, bidirectional: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__(d_model, bidirectional, dropout_rate)
        init_nplr(self, d_state)
        self.c = nn.Parameter(torch.zeros(2 if bidirectional else 1, d_model, d_state, 2))

    def kernels(self, length: int) -> torch.Tensor:
        lam, p, b = nplr_dplr(self)
        dt = torch.exp(self.log_dt)
        return torch.stack([s4_nplr_kernel(lam, p, b, complex_pair(c), dt, length)
                            for c in self.c])


class FFLayer(nn.Module):
    """``ff1`` -> tanh GELU -> dropout -> ``ff2`` (state_spaces/ff.py)."""

    def __init__(self, d_model: int, expand: int = 2, dropout_rate: float = 0.0):
        super().__init__()
        self.ff1 = Dense(d_model, d_model * expand)
        self.ff2 = Dense(d_model * expand, d_model)
        self.dropout_rate = dropout_rate

    def forward(self, x, rng: Optional[StepRNG] = None):
        h = dropout(gelu_tanh(self.ff1(x)), active_rate(self, self.dropout_rate), rng)
        return self.ff2(h)


class MHALayer(nn.Module):
    """Dense self-attention ``mha`` with a key mask, causal unless the
    stack is bidirectional."""

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float, causal: bool):
        super().__init__()
        self.causal = causal
        self.mha = MultiHeadedAttention(d_model, num_heads, dropout_rate)

    def forward(self, x, valid, rng: Optional[StepRNG] = None):
        mask = valid[:, None, :]
        if self.causal:
            t = x.shape[1]
            mask = mask & torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None]
        return self.mha(x, x, x, mask, rng=rng)


def make_layer(name: str, cfg: ConformerConfig) -> Tuple[str, nn.Module]:
    """The layer registry (state_spaces/registry.py: s4 | s4d | ff | mha)
    -> (flax's auto name, module)."""
    d = cfg.output_size
    if name == "s4":
        return "S4Core_0", S4Core(d, cfg.ss_d_state, cfg.ss_bidirectional, cfg.dropout_rate)
    if name == "s4d":
        return "S4DCore_0", S4DCore(d, cfg.ss_d_state, cfg.ss_bidirectional, cfg.dropout_rate)
    if name == "ff":
        return "FFLayer_0", FFLayer(d, cfg.ss_ff_expand, cfg.dropout_rate)
    if name == "mha":
        return "MHALayer_0", MHALayer(d, cfg.attention_heads, cfg.attention_dropout_rate,
                                      causal=not cfg.ss_bidirectional)
    raise ValueError(f"unknown state-spaces layer {name!r}")


RESIDUALS = ("residual", "R", "affine", "A", "feedforward", "F", "none", "ff", "highway", "H",
             "decay", "D")


class ResidualFn(nn.Module):
    """combine(x, y) (state_spaces/residual.py): residual x + y; affine
    x + c y (``affine``, init 1); feedforward y; highway (1 - r) x + r y,
    r = sigmoid(``Wx`` x + ``Wy`` y); decay a x + b y, b = i_layer^-1/2,
    a = sqrt(1 - b^2)."""

    def __init__(self, kind: str, d_model: int, i_layer: int):
        super().__init__()
        if kind not in RESIDUALS:
            raise ValueError(f"unknown residual {kind!r}")
        self.kind, self.i_layer = kind, i_layer
        if kind in ("affine", "A"):
            self.affine = nn.Parameter(torch.ones(1))
        elif kind in ("highway", "H"):
            self.Wx = Dense(d_model, d_model)
            self.Wy = Dense(d_model, d_model)

    def forward(self, x, y):
        if self.kind in ("residual", "R"):
            return x + y
        if self.kind in ("affine", "A"):  # float32 (at least), as JAX promotes it
            return x + self.affine * y
        if self.kind in ("highway", "H"):
            r = sigmoid(self.Wx(x) + self.Wy(y))
            return (1.0 - r) * x + r * y
        if self.kind in ("decay", "D"):
            beta = self.i_layer ** -0.5
            return (1.0 - beta ** 2) ** 0.5 * x + beta * y
        return y


class Norm(nn.Module):
    """``ln`` (LayerNorm, flax's default eps 1e-6), ``bn`` (the masked batch
    norm) or nothing (state_spaces/components.py Normalization) of x (+
    ``residual``: the LayerNorm reads the sum unrounded, models/
    transformer.py add_and_norm); a norm's output is in ``dtype`` (flax's
    ``dtype``), nothing returns the sum as it is."""

    def __init__(self, kind: str, d_model: int):
        super().__init__()
        self.kind = kind
        if kind == "layer":
            self.ln = LayerNorm(d_model, eps=1e-6)
        elif kind == "batch":
            self.bn = MaskedBatchNorm(d_model)
        elif kind not in ("none", ""):
            raise ValueError(f"unknown norm {kind!r}")

    def forward(self, x, valid, dtype: torch.dtype, residual: Optional[torch.Tensor] = None):
        if self.kind == "layer":
            return self.ln(x, residual).to(dtype)
        x = x if residual is None else x + residual
        if self.kind == "batch":
            return self.bn(x, valid).to(dtype)
        return x


def pool_lengths(lengths: torch.Tensor, stride: int) -> torch.Tensor:
    return torch.div(lengths + stride - 1, stride, rounding_mode="floor")


class Pool(nn.Module):
    """Down-pooling of time by ``stride`` (state_spaces/pool.py): sample (a
    strided slice), avg (the window's mean, the tail zero-padded) or
    linear (the window flattened through ``pool_lin``)."""

    def __init__(self, kind: str, stride: int, d_model: int):
        super().__init__()
        if kind not in ("sample", "avg", "pool", "linear"):
            raise ValueError(f"unknown pool {kind!r}")
        self.kind, self.stride = kind, stride
        if kind == "linear":
            self.pool_lin = Dense(stride * d_model, d_model)

    def forward(self, x, dtype: torch.dtype):
        """``dtype``: the compute dtype, which ``pool_lin`` reads."""
        b, t, d = x.shape
        s = self.stride
        if self.kind == "sample":
            return x[:, ::s]
        pad = (-t) % s
        xw = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(b, (t + pad) // s, s, d)
        if self.kind == "linear":
            return self.pool_lin(xw.reshape(b, (t + pad) // s, s * d).to(dtype))
        return xw.mean(dim=2)


class SequenceResidualBlock(nn.Module):
    """norm / layer / dropout / stochastic depth / residual
    (state_spaces/block.py)."""

    def __init__(self, cfg: ConformerConfig, layer_name: str, i_layer: int):
        super().__init__()
        self.cfg, self.layer_name = cfg, layer_name
        self.layer_attr, layer = make_layer(layer_name, cfg)
        self.add_module(self.layer_attr, layer)
        self.norm = Norm(cfg.ss_norm, cfg.output_size)
        self.residual = ResidualFn(cfg.ss_residual, cfg.output_size, i_layer)

    def forward(self, x, valid, dtype: torch.dtype, rng: Optional[StepRNG] = None,
                pending: Optional[torch.Tensor] = None):
        """(x, pending): ``dtype`` is the compute dtype, which every layer
        reads; ``pending`` a residual branch still to add to x, which the
        pre-norm reads unrounded in the sum (the plain ``residual`` of a
        pre-norm block hands its own on so)."""
        cfg = self.cfg
        if cfg.ss_prenorm:
            y = self.norm(x, valid, dtype, pending)
        else:
            y = x
        if pending is not None:
            x = x + pending
        y = y.to(dtype)
        layer = getattr(self, self.layer_attr)
        if self.layer_name == "mha":
            y = layer(y, valid, rng)
        else:
            y = layer(y.masked_fill(~valid[..., None], 0.0), rng)
        y = dropout(y, active_rate(self, cfg.dropout_rate), rng)
        if cfg.ss_drop_path > 0.0 and self.training:
            if rng is None:
                raise ValueError("stochastic depth in training mode needs a StepRNG")
            keep = torch.rand(x.shape[0], 1, 1, generator=rng.device,
                              device=x.device) < 1.0 - cfg.ss_drop_path
            y = torch.where(keep, y / (1.0 - cfg.ss_drop_path), 0.0)
        if self.residual.kind in ("residual", "R"):
            if cfg.ss_prenorm:
                return x, y
            return self.norm(x, valid, dtype, y), None
        x = self.residual(x, y)
        return (x if cfg.ss_prenorm else self.norm(x, valid, dtype)), None


class SequenceModel(nn.Module):
    """``num_blocks`` groups of the ``ss_layers`` cycle, pooled between
    groups, then ``final_norm``: (x, lengths) -> (x, lengths)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        i = 0
        for g in range(cfg.num_blocks):
            for lname in cfg.ss_layers:
                i += 1
                self.add_module(f"block_{g}_{lname}_{i}", SequenceResidualBlock(cfg, lname, i))
            if self._pools(g):
                self.add_module(f"pool_{g}", Pool(cfg.ss_pool, cfg.ss_pool_stride,
                                                  cfg.output_size))
        self.final_norm = Norm(cfg.ss_norm, cfg.output_size)

    def _pools(self, g: int) -> bool:
        cfg = self.cfg
        return bool(cfg.ss_pool) and cfg.ss_pool_stride > 1 and g < cfg.num_blocks - 1

    def forward(self, x, lengths, rng: Optional[StepRNG] = None):
        """x in the compute dtype."""
        cfg = self.cfg
        dtype = x.dtype
        i, pending = 0, None
        for g in range(cfg.num_blocks):
            valid = make_valid_mask(lengths, x.shape[1])
            for lname in cfg.ss_layers:
                i += 1
                x, pending = getattr(self, f"block_{g}_{lname}_{i}")(x, valid, dtype, rng,
                                                                     pending)
            if self._pools(g):
                if pending is not None:
                    x, pending = x + pending, None
                x = getattr(self, f"pool_{g}")(x, dtype)
                lengths = pool_lengths(lengths, cfg.ss_pool_stride)
        valid = make_valid_mask(lengths, x.shape[1])
        return self.final_norm(x, valid, dtype, pending), lengths


class S4Encoder(nn.Module):
    """[B, T, F] features -> ([B, T', D], [B] lengths): ``embed``
    (``conv2d`` or ``linear``), dropout at ``positional_dropout_rate``, the
    ``trunk``.  The output's pad frames are not zeroed (JAX's neither)."""

    def __init__(self, cfg: ConformerConfig, input_size: int,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        refuse_no_input_layer(cfg)
        self.cfg = cfg
        self.output_size = cfg.output_size
        with torch.device(resolve_device(device)):
            self.embed, _ = input_layer(cfg.input_layer, input_size, cfg.output_size)
            self.trunk = SequenceModel(cfg)

    def forward(self, feats, feats_lengths,
                rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        x, lengths = embed_features(self, feats, feats_lengths)
        x = dropout(x, active_rate(self, self.cfg.positional_dropout_rate), rng)
        return self.trunk(x, lengths, rng)
