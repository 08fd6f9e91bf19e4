"""Speech frontend: STFT power -> log-mel -> MVN (counterpart of llm_guided_asr_tpu/ops/frontend.py).

Same numerics as the JAX frontend: reflect-padded centred frames, periodic
Hann window, one-sided DFT as one float32 matmul against the windowed
cos/-sin basis, Slaney mel filterbank (librosa-compatible, computed in
numpy), natural log with a 1e-10 clamp.  The functions run on the device of
their input tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask, mask_fill


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """DefaultFrontend settings (the single-channel log-mel subset)."""

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


def stft_power(
    speech: torch.Tensor,
    n_fft: int = 512,
    win_length: Optional[int] = None,
    hop_length: int = 128,
    center: bool = True,
    window: Optional[str] = "hann",
) -> torch.Tensor:
    """[B, S] -> [B, T, F] one-sided power spectrum.

    Frames are a strided view of the padded signal; the DFT is one float32
    matmul against the windowed basis (full float32: TF32 is off on the
    card, see utils/device.py), matching the JAX frontend's HIGHEST-precision
    DFT.
    """
    speech = speech.float()
    if center:
        pad = n_fft // 2
        speech = torch.nn.functional.pad(speech[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = speech.unfold(1, n_fft, hop_length)  # [B, T, n_fft]
    basis = torch.from_numpy(_dft_basis(n_fft, win_length, window)).to(speech.device)
    out = frames @ basis
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
    melmat = torch.from_numpy(mel_filterbank(fs, n_fft, n_mels, fmin, fmax, htk)).to(power.device)
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
