"""S4 (structured state-space) decoder (counterpart of llm_guided_asr_tpu/models/s4_decoder.py).

ESPnet's ``--decoder s4``: embed -> per block pre-norm [SSM over the
token axis (causal by construction) -> cross-attention to the encoder ->
FFN], pads zeroed after every block, ``final_ln`` and ``output``.  Two SSM
kernels:

- S4D (``kernel: diag``, :class:`S4DLayer`): the kernel is a Vandermonde
  product in complex64, K[l] = 2 Re(sum_n C_n (Abar_n - 1)/A_n Abar_n^l)
  with Abar = exp(dt A);
- NPLR S4 (``kernel: nplr``, :class:`S4NPLRLayer`): the HiPPO-LegS
  transition in diagonal-plus-low-rank form (:func:`hippo_legs_dplr`,
  numpy float64 at init), bilinear discretization, the kernel evaluated
  at the L roots of unity by four Cauchy sums and the Woodbury identity
  (:func:`s4_nplr_kernel`), then an inverse FFT.

Either kernel convolves the sequence causally by FFT (length 2L), then
``+ D u``, the tanh GELU (jax.nn.gelu's default) and ``out_proj``.  The
task selects ``diag`` only; ``nplr`` is reachable at module level.
models/state_spaces.py imports the NPLR pieces from here.  Every
LayerNorm takes eps 1e-5.

Compute dtype: the encoder rows' (the model casts them); the embedding
rows are cast to it.  The FFT convolution runs in float32, its output is
cast to the compute dtype and ``+ D u`` promotes to float32 through the
float32 ``d`` (as JAX promotes it) until ``out_proj`` casts back; the
diagonal kernel is rounded to the compute dtype first, the NPLR one is not
(JAX models/s4_decoder.py:113-124, 228-238).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import gelu_tanh
from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    MultiHeadedAttention,
    PositionwiseFeedForward,
    add_and_norm,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG


@dataclasses.dataclass(frozen=True)
class S4DecoderConfig:
    vocab_size: int = 100
    d_model: int = 256
    d_state: int = 16  # N (S4D: N // 2 complex modes)
    n_layers: int = 4
    attention_heads: int = 4
    linear_units: int = 1024
    dropout_rate: float = 0.0
    kernel: str = "diag"  # diag (S4D) | nplr


def complex_pair(x: torch.Tensor) -> torch.Tensor:
    """A parameter stored as a trailing (real, imag) pair -> complex64."""
    return torch.complex(x[..., 0].float(), x[..., 1].float())


def fft_causal_conv(u: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """u [B, L, H] convolved causally with kernel [H, L] by FFT of length
    2L, in float32 -> [B, L, H]."""
    length = u.shape[1]
    nfft = 2 * length
    uf = torch.fft.rfft(u.transpose(1, 2).float(), n=nfft)
    kf = torch.fft.rfft(kernel.float(), n=nfft)
    return torch.fft.irfft(uf * kf[None], n=nfft)[..., :length].transpose(1, 2)


def s4d_kernel(log_dt: torch.Tensor, log_a_re: torch.Tensor, a_im: torch.Tensor,
               c: torch.Tensor, length: int) -> torch.Tensor:
    """The S4D convolution kernel [..., H, L] (SSKernelDiag, ZOH): log_dt
    [H]; log_a_re, a_im [..., H, N]; c [..., H, N, 2]."""
    dt = torch.exp(log_dt)[:, None]
    a = torch.complex(-torch.exp(log_a_re), a_im)
    dta = dt * a
    bbar = (torch.exp(dta) - 1.0) / a
    pos = torch.arange(length, device=log_dt.device, dtype=torch.float32)
    powers = torch.exp(dta[..., None] * pos)  # [..., H, N, L]
    return 2.0 * torch.einsum("...hn,...hnl->...hl", complex_pair(c) * bbar, powers).real


def hippo_legs_dplr(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """HiPPO-LegS transition -> (Lambda, P, B) of its diagonal-plus-low-rank
    form, complex64 (numpy, float64 ``eigh``; transition('legs') and
    rank_correction of state_spaces/s4.py: A + P P^T is normal, so the
    eigenbasis of its skew part diagonalises it)."""
    q = np.arange(n, dtype=np.float64)
    col, row = np.meshgrid(q, q)
    r = np.sqrt((2 * col + 1) * (2 * row + 1))
    A = -np.where(row > col, r, 0.0) - np.diag(q + 1)
    P = np.sqrt(q + 0.5)
    B = np.sqrt(2 * q + 1.0)
    S = A + P[:, None] * P[None, :]
    lam_re = np.mean(np.diagonal(S))
    lam_im, V = np.linalg.eigh(S * -1j)
    Lambda = lam_re + 1j * lam_im
    P = V.conj().T @ P
    B = V.conj().T @ B
    return Lambda.astype(np.complex64), P.astype(np.complex64), B.astype(np.complex64)


def s4_nplr_kernel(Lambda: torch.Tensor, P: torch.Tensor, B: torch.Tensor, Ct: torch.Tensor,
                   dt: torch.Tensor, length: int) -> torch.Tensor:
    """SSKernelNPLR's forward: the length-L kernel [H, L] (real) of the
    bilinear-discretized DPLR SSM.  Lambda, P, B [N] complex; Ct [H, N]
    complex (C-tilde); dt [H].  At the L roots of unity w: g = (2/dt)
    (1-w)/(1+w), four Cauchy sums over 1/(g - Lambda), the Woodbury
    correction, then an inverse FFT."""
    pos = torch.arange(length, device=dt.device, dtype=torch.float32) / length
    omega = torch.exp(torch.complex(torch.zeros_like(pos), -2.0 * math.pi * pos))
    g = (2.0 / dt[:, None]) * ((1.0 - omega) / (1.0 + omega))[None, :]  # [H, L]
    c = 2.0 / (1.0 + omega)
    recip = 1.0 / (g[..., None] - Lambda[None, None, :])  # [H, L, N]
    k00 = torch.einsum("hn,hln->hl", Ct.conj() * B[None, :], recip)
    k01 = torch.einsum("hn,hln->hl", Ct.conj() * P[None, :], recip)
    k10 = torch.einsum("n,hln->hl", P.conj() * B, recip)
    k11 = torch.einsum("n,hln->hl", P.conj() * P, recip)
    at_roots = c[None, :] * (k00 - k01 * (1.0 / (1.0 + k11)) * k10)
    return torch.fft.ifft(at_roots, n=length, dim=-1).real


class S4DLayer(nn.Module):
    """Diagonal SSM over the sequence axis: [B, L, H] -> [B, L, H]."""

    def __init__(self, cfg: S4DecoderConfig):
        super().__init__()
        h, n = cfg.d_model, cfg.d_state // 2
        self.log_dt = nn.Parameter(torch.zeros(h))
        s4d_init(self, (h, n))
        self.c = nn.Parameter(torch.zeros(h, n, 2))
        self.d = nn.Parameter(torch.ones(h))
        self.out_proj = Dense(h, h)

    def forward(self, u):
        # the kernel rounded to the compute dtype (JAX models/s4_decoder.py:113-115)
        kernel = s4d_kernel(self.log_dt, self.log_a_re, self.a_im, self.c, u.shape[1])
        y = fft_causal_conv(u, kernel.to(u.dtype)).to(u.dtype) + u * self.d
        return self.out_proj(gelu_tanh(y), u.dtype)


def init_nplr(module: nn.Module, n: int) -> None:
    """Register the trainable HiPPO-LegS state of an NPLR layer on
    ``module`` at its init values: Lambda = -exp(``log_neg_re``) + i
    ``lam_im`` (the real part kept negative), ``p`` and ``b`` as (real,
    imag) pairs [N, 2]."""
    lam0, p0, b0 = hippo_legs_dplr(n)
    f32 = lambda a: torch.tensor(a.astype(np.float32))  # noqa: E731  (on the default device)
    module.log_neg_re = nn.Parameter(f32(np.log(-lam0.real)))
    module.lam_im = nn.Parameter(f32(lam0.imag))
    module.p = nn.Parameter(f32(np.stack([p0.real, p0.imag], -1)))
    module.b = nn.Parameter(f32(np.stack([b0.real, b0.imag], -1)))


def nplr_dplr(module: nn.Module) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Lambda, P, B) complex64 of a module set up by :func:`init_nplr`."""
    lam = torch.complex(-torch.exp(module.log_neg_re), module.lam_im)
    return lam, complex_pair(module.p), complex_pair(module.b)


def s4d_init(module: nn.Module, shape: Tuple[int, ...]) -> None:
    """S4D-Lin's A_n = -1/2 + i pi n: ``log_a_re`` and ``a_im`` of ``shape``
    [..., N]."""
    module.log_a_re = nn.Parameter(torch.full(shape, math.log(0.5)))
    module.a_im = nn.Parameter((math.pi * torch.arange(shape[-1], dtype=torch.float32))
                               .expand(shape).clone())


class S4NPLRLayer(nn.Module):
    """Full S4 (NPLR) layer: [B, L, H] -> [B, L, H]."""

    def __init__(self, cfg: S4DecoderConfig):
        super().__init__()
        h = cfg.d_model
        init_nplr(self, cfg.d_state)
        self.log_dt = nn.Parameter(torch.zeros(h))
        self.c = nn.Parameter(torch.zeros(h, cfg.d_state, 2))
        self.d = nn.Parameter(torch.ones(h))
        self.out_proj = Dense(h, h)

    def forward(self, u):
        kernel = s4_nplr_kernel(*nplr_dplr(self), complex_pair(self.c), torch.exp(self.log_dt),
                                u.shape[1])
        y = fft_causal_conv(u, kernel).to(u.dtype) + u * self.d
        return self.out_proj(gelu_tanh(y), u.dtype)


SSM_LAYERS = {"diag": S4DLayer, "nplr": S4NPLRLayer}


class S4Decoder(nn.Module):
    """(enc [B, T, enc_dim], lengths, ys_in [B, L], lengths) -> logits
    [B, L, V] (``enc_dim`` defaults to ``d_model``): ``embed`` (clipped
    tokens, pads zeroed), ``n_layers`` blocks of ``s4_ln_{i}``/``s4_{i}``,
    ``att_ln_{i}``/``cross_{i}`` and ``ffn_ln_{i}``/``ffn_{i}`` residual
    branches (dropout only inside the attention and the FFN), ``final_ln``,
    ``output``."""

    def __init__(self, cfg: S4DecoderConfig, enc_dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.kernel not in SSM_LAYERS:
            raise ValueError(f"S4 kernel={cfg.kernel!r}; expected one of {sorted(SSM_LAYERS)}")
        self.cfg = cfg
        d = cfg.d_model
        with torch.device(resolve_device(device)):
            self.embed = nn.Embedding(cfg.vocab_size, d)
            for i in range(cfg.n_layers):
                self.add_module(f"s4_ln_{i}", LayerNorm(d))
                self.add_module(f"s4_{i}", SSM_LAYERS[cfg.kernel](cfg))
                self.add_module(f"att_ln_{i}", LayerNorm(d))
                self.add_module(f"cross_{i}", MultiHeadedAttention(
                    d, cfg.attention_heads, cfg.dropout_rate, kv_dim=enc_dim))
                self.add_module(f"ffn_ln_{i}", LayerNorm(d))
                self.add_module(f"ffn_{i}", PositionwiseFeedForward(
                    d, cfg.linear_units, dropout_rate=cfg.dropout_rate))
            self.final_ln = LayerNorm(d)
            self.output = Dense(d, cfg.vocab_size)

    def forward(self, enc: torch.Tensor, enc_lengths: torch.Tensor, ys_in: torch.Tensor,
                ys_in_lengths: torch.Tensor, rng: Optional[StepRNG] = None,
                only_last: bool = False) -> torch.Tensor:
        cfg = self.cfg
        b, length = ys_in.shape
        pad = ~make_valid_mask(ys_in_lengths, length)[..., None]
        x = self.embed(ys_in.clamp(0, cfg.vocab_size - 1)).to(enc.dtype).masked_fill(pad, 0.0)
        mem_mask = make_valid_mask(enc_lengths, enc.shape[1])[:, None, :]
        for i in range(cfg.n_layers):
            sub = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            x, h = add_and_norm(x, sub("s4")(sub("s4_ln")(x)), sub("att_ln"))
            x, h = add_and_norm(x, sub("cross")(h, enc, enc, mem_mask, rng=rng), sub("ffn_ln"))
            x = x + sub("ffn")(h, rng)
            x = x.masked_fill(pad, 0.0)
        x = self.final_ln(x)
        if only_last:
            x = x[torch.arange(b, device=x.device), ys_in_lengths - 1]
        return self.output(x)
