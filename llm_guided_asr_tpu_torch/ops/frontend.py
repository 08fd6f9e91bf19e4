"""Speech frontend: STFT power -> log-mel -> MVN (counterpart of llm_guided_asr_tpu/ops/frontend.py).

Same numerics as the JAX frontend: reflect-padded centred frames, periodic
Hann window, one-sided DFT as one float32 matmul against the windowed
cos/-sin basis, Slaney mel filterbank (librosa-compatible, computed in
numpy), natural log with a 1e-10 clamp.  The functions run on the device of
their input tensor.

:class:`MultichannelFrontend` is the [B, S, C] path: a complex STFT per
channel, optional WPE, a BiLSTM mask estimator whose two directions are
the LSTM recurrence kernels of ops/lstm.py, MVDR (ops/beamformer.py), then
power and log-mel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.lm import LSTMCell, lstm_stack
from llm_guided_asr_tpu_torch.ops.beamformer import mvdr_beamform, wpe_dereverb
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask, mask_fill


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """DefaultFrontend settings: ``type`` "default" is the log-mel
    frontend, "sliding_window" raw frames of ``win_length`` (default 400)
    samples for the sinc pre-encoder; a non-empty ``fused`` ((n_fft,
    hop_length, n_mels) triples) is :class:`FusedFrontend`.  ``use_wpe``
    or ``use_beamformer`` engage :class:`MultichannelFrontend` on a
    [B, S, C] batch; without either, such a batch is read at
    ``ref_channel``."""

    fs: int = 16000
    n_fft: int = 512
    win_length: Optional[int] = None
    hop_length: int = 128
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None
    htk: bool = False
    center: bool = True
    window: Optional[str] = "hann"
    use_wpe: bool = False
    wpe_taps: int = 5
    wpe_delay: int = 3
    wpe_iterations: int = 2
    use_beamformer: bool = False
    mask_units: int = 64
    ref_channel: int = 0
    fused: Tuple[Tuple[int, int, int], ...] = ()
    proj_dim: int = 100
    type: str = "default"  # default | sliding_window

    @property
    def output_dim(self) -> int:
        if self.type == "sliding_window":
            return self.win_length or 400
        return self.proj_dim * len(self.fused) if self.fused else self.n_mels

    @property
    def multichannel(self) -> bool:
        """Whether a [B, S, C] batch goes through :class:`MultichannelFrontend`."""
        return self.use_wpe or self.use_beamformer


def require_log_mel(cfg: Optional[FrontendConfig], model: str) -> None:
    """Raise unless ``cfg`` is the log-mel frontend (or None): the fused,
    sliding-window and multichannel frontends are read by the
    CTC/attention model only (the JAX package ignores them elsewhere)."""
    if cfg is not None and (cfg.fused or cfg.type != "default" or cfg.multichannel):
        raise ValueError(f"frontend_conf.fused/type/use_wpe/use_beamformer are read by the "
                         f"CTC/attention model only, not by {model}")


def _hz_to_mel(freqs, htk: bool = False) -> np.ndarray:
    freqs = np.asarray(freqs, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freqs / 700.0)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = freqs >= min_log_hz
    return np.where(
        above, min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz(mels, htk: bool = False) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = mels >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    fs: int = 16000,
    n_fft: int = 512,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
) -> np.ndarray:
    """[n_fft//2+1, n_mels] triangular mel filterbank, Slaney-normalised."""
    if fmax is None:
        fmax = fs / 2.0
    fftfreqs = np.linspace(0.0, fs / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_length: Optional[int], window: Optional[str]) -> np.ndarray:
    """[n_fft, 2F] windowed DFT basis: cos columns then -sin columns."""
    win_length = win_length or n_fft
    w = np.ones(n_fft, np.float32)
    if window is not None:
        if window != "hann":
            raise ValueError(f"unsupported window: {window}")
        n = np.arange(win_length, dtype=np.float64)
        w = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
        if win_length < n_fft:
            left = (n_fft - win_length) // 2
            w = np.pad(w, (left, n_fft - win_length - left))
    f = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft, dtype=np.float64), np.arange(f)) / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32) * w[:, None]


def stft_out_lengths(ilens: torch.Tensor, n_fft: int = 512, hop_length: int = 128,
                     center: bool = True) -> torch.Tensor:
    """Per-utterance valid frame counts (stft.py:163-171)."""
    if center:
        ilens = ilens + 2 * (n_fft // 2)
    return torch.div(ilens - n_fft, hop_length, rounding_mode="floor") + 1


def _stft_parts(speech: torch.Tensor, n_fft: int, win_length: Optional[int], hop_length: int,
                center: bool, window: Optional[str]) -> torch.Tensor:
    """[B, S] -> [B, T, 2F]: the one-sided DFT's real parts, then its
    imaginary parts.  Frames are a strided view of the padded signal; the
    DFT is one float32 matmul against the windowed basis (full float32:
    TF32 is off on the card, see utils/device.py), matching the JAX
    frontend's HIGHEST-precision DFT; float64 input stays float64 (a
    float64 copy of a model is the rounding arbiter of the tests)."""
    if speech.dtype != torch.float64:
        speech = speech.float()
    if center:
        pad = n_fft // 2
        speech = torch.nn.functional.pad(speech[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = speech.unfold(1, n_fft, hop_length)  # [B, T, n_fft]
    basis = torch.from_numpy(_dft_basis(n_fft, win_length, window)).to(speech.device,
                                                                       speech.dtype)
    return frames @ basis


def stft(
    speech: torch.Tensor,
    n_fft: int = 512,
    win_length: Optional[int] = None,
    hop_length: int = 128,
    center: bool = True,
    window: Optional[str] = "hann",
) -> torch.Tensor:
    """[B, S] -> complex [B, T, F] one-sided STFT (the JAX ``stft``):
    complex64, complex128 for float64 input."""
    out = _stft_parts(speech, n_fft, win_length, hop_length, center, window)
    f = n_fft // 2 + 1
    return torch.complex(out[..., :f], out[..., f:])


def stft_power(
    speech: torch.Tensor,
    n_fft: int = 512,
    win_length: Optional[int] = None,
    hop_length: int = 128,
    center: bool = True,
    window: Optional[str] = "hann",
) -> torch.Tensor:
    """[B, S] -> [B, T, F] one-sided power spectrum."""
    out = _stft_parts(speech, n_fft, win_length, hop_length, center, window)
    f = n_fft // 2 + 1
    return out[..., :f] ** 2 + out[..., f:] ** 2


def logmel_from_power(
    power: torch.Tensor,
    fs: int = 16000,
    n_fft: int = 512,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
) -> torch.Tensor:
    """[B, T, F] power -> [B, T, M] natural-log mel (log_mel.py:57-73)."""
    melmat = torch.from_numpy(mel_filterbank(fs, n_fft, n_mels, fmin, fmax, htk)).to(
        power.device, power.dtype)
    return torch.log(torch.clamp(power @ melmat, min=1e-10))


def global_mvn(
    feats: torch.Tensor,
    mean: torch.Tensor,
    inv_std: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    norm_means: bool = True,
    norm_vars: bool = True,
) -> torch.Tensor:
    """Global CMVN from collect-stats artifacts (global_mvn.py:13)."""
    if norm_means:
        feats = feats - mean
    if norm_vars:
        feats = feats * inv_std
    if lengths is not None:
        feats = mask_fill(feats, make_valid_mask(lengths, feats.shape[1]))
    return feats


def utterance_mvn(
    feats: torch.Tensor,
    lengths: torch.Tensor,
    norm_means: bool = True,
    norm_vars: bool = False,
    eps: float = 1.0e-20,
) -> torch.Tensor:
    """Per-utterance MVN over valid frames (utterance_mvn.py:10)."""
    valid = make_valid_mask(lengths, feats.shape[1])[..., None]
    denom = torch.clamp(lengths[:, None, None].to(feats.dtype), min=1.0)
    zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
    mean = torch.where(valid, feats, zero).sum(dim=1, keepdim=True) / denom
    if norm_means:
        feats = torch.where(valid, feats - mean, zero)
        if norm_vars:
            var = torch.where(valid, feats**2, zero).sum(dim=1, keepdim=True) / denom
            feats = torch.where(valid, feats * torch.rsqrt(torch.clamp(var, min=eps)), zero)
    elif norm_vars:
        sq = torch.where(valid, (feats - mean) ** 2, zero).sum(dim=1, keepdim=True) / denom
        feats = torch.where(valid, feats * torch.rsqrt(torch.clamp(sq, min=eps)), zero)
    return feats


def default_frontend(
    speech: torch.Tensor,
    speech_lengths: torch.Tensor,
    fs: int = 16000,
    n_fft: int = 512,
    win_length: Optional[int] = None,
    hop_length: int = 128,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    center: bool = True,
    window: Optional[str] = "hann",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] audio -> ([B, T, n_mels] log-mel, [B] frame lengths)
    (default.py:82-117); padding frames are zeroed."""
    power = stft_power(speech, n_fft, win_length, hop_length, center, window)
    feats = logmel_from_power(power, fs, n_fft, n_mels, fmin, fmax, htk)
    olens = stft_out_lengths(speech_lengths, n_fft, hop_length, center)
    olens = torch.clamp(olens, 0, feats.shape[1])
    return mask_fill(feats, make_valid_mask(olens, feats.shape[1])), olens


class FusedFrontend(nn.Module):
    """Multi-resolution fused frontend (fused.py FusedFrontends,
    align_method linear_projection): one log-mel frontend per
    (n_fft, hop_length, n_mels) triple, each projected to ``proj_dim`` by
    ``proj_{i}``, resampled by nearest index to the first one's frames,
    concatenated ([B, T0, proj_dim * len(frontends)]) with the first one's
    lengths; pad frames zeroed."""

    def __init__(self, frontends: Tuple[Tuple[int, int, int], ...], proj_dim: int = 100,
                 fs: int = 16000):
        super().__init__()
        self.frontends, self.fs = tuple(tuple(f) for f in frontends), fs
        for i, (_, _, mels) in enumerate(self.frontends):
            setattr(self, f"proj_{i}", nn.Linear(mels, proj_dim))

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        outs, t0, lens0 = [], None, None
        for i, (n_fft, hop, mels) in enumerate(self.frontends):
            f, lens = default_frontend(speech, speech_lengths, fs=self.fs, n_fft=n_fft,
                                       hop_length=hop, n_mels=mels)
            p = getattr(self, f"proj_{i}")(f)
            if i == 0:
                t0, lens0 = p.shape[1], lens
            else:
                idx = torch.clamp(torch.div(torch.arange(t0, device=p.device) * p.shape[1], t0,
                                            rounding_mode="floor"), 0, p.shape[1] - 1)
                p = p[:, idx]
            outs.append(p)
        feats = torch.cat(outs, dim=-1)
        return mask_fill(feats, make_valid_mask(lens0, t0)), lens0


class MultichannelFrontend(nn.Module):
    """Multichannel DefaultFrontend (the JAX ``MultichannelFrontend``):
    per-channel complex STFT -> (``use_wpe``) WPE -> (``use_beamformer``)
    mask estimator and MVDR, else the reference channel -> power -> log-mel,
    pad frames zeroed.  speech [B, S, C] -> ([B, T, n_mels], [B]).

    The mask estimator reads the reference channel's log magnitude
    [B, T, F]: a forward LSTM of ``mask_units`` and a reverse one,
    concatenated, then ``mask_out`` (Dense 2F) and a sigmoid give the
    speech and noise masks.  Each direction is one input-projection GEMM
    and one launch of the recurrence kernel.  The reverse one runs over the
    whole padded row from its end and keeps the order (flax's
    ``nn.RNN(reverse=True, keep_order=True)`` without ``seq_lengths``).
    flax auto-names the cells ``OptimizedLSTMCell_0`` (forward) and
    ``OptimizedLSTMCell_1`` (reverse) at the frontend's top level (the
    ``mask_lstm_f``/``mask_lstm_b`` wrappers hold no parameters).  The
    estimator trains with the recognizer; WPE and MVDR have no
    parameters."""

    def __init__(self, cfg: FrontendConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.use_beamformer:
            f = cfg.n_fft // 2 + 1
            self.OptimizedLSTMCell_0 = LSTMCell(cfg.mask_units, f)
            self.OptimizedLSTMCell_1 = LSTMCell(cfg.mask_units, f)
            self.mask_out = nn.Linear(2 * cfg.mask_units, 2 * f)

    def masks(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """complex [B, F, C, T] -> the speech and noise masks [B, F, T]."""
        logmag = torch.log(y[:, :, self.cfg.ref_channel, :].abs() + 1e-6)
        h = logmag.transpose(1, 2)  # [B, T, F]
        fwd = lstm_stack([self.OptimizedLSTMCell_0], h)
        bwd = lstm_stack([self.OptimizedLSTMCell_1], h.flip(1)).flip(1)
        hh = torch.cat([fwd, bwd], dim=-1)
        m = torch.sigmoid(self.mask_out(hh)).transpose(1, 2)  # [B, 2F, T]
        f = y.shape[1]
        return m[:, :f], m[:, f:]

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        b, s, ch = speech.shape
        spec = stft(speech.movedim(-1, 1).reshape(b * ch, s), c.n_fft, c.win_length,
                    c.hop_length, c.center, c.window)  # [B*C, T, F]
        t, f = spec.shape[1], spec.shape[2]
        y = spec.reshape(b, ch, t, f).permute(0, 3, 1, 2)  # [B, F, C, T]
        if c.use_wpe:
            y = wpe_dereverb(y, c.wpe_taps, c.wpe_delay, c.wpe_iterations)
        if c.use_beamformer:
            enhanced = mvdr_beamform(y, *self.masks(y), c.ref_channel)
        else:
            enhanced = y[:, :, c.ref_channel, :]
        power = (enhanced.real ** 2 + enhanced.imag ** 2).transpose(1, 2)  # [B, T, F]
        feats = logmel_from_power(power, c.fs, c.n_fft, c.n_mels, c.fmin, c.fmax, c.htk)
        olens = torch.clamp(stft_out_lengths(speech_lengths, c.n_fft, c.hop_length, c.center),
                            0, feats.shape[1])
        return mask_fill(feats, make_valid_mask(olens, feats.shape[1])), olens
