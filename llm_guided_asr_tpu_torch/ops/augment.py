"""Waveform augmentations (counterpart of llm_guided_asr_tpu/ops/augment.py):
speed perturbation, the recipe's stage-2 sox analog, RIR convolution and
additive noise.

The reference applies sox speed 0.9/1.0/1.1 offline (asr.sh:579
perturb_data_dir_speed); here speed perturbation is linear resampling,
used offline (bin/asr_pipeline.py stage 2) or on the fly in a
preprocessor (preprocessor.py's speech augmentation hooks).  Host numpy,
as in JAX: the data path prepares waveforms on the CPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def speed_perturb(wav: np.ndarray, factor: float) -> np.ndarray:
    """Resample by 1/factor: factor > 1 -> faster (shorter) audio."""
    if factor == 1.0:
        return wav
    n = len(wav)
    out_n = int(round(n / factor))
    src = np.arange(out_n, dtype=np.float64) * factor
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n - 1)
    frac = (src - i0).astype(wav.dtype)
    return wav[i0] * (1 - frac) + wav[i1] * frac


def perturb_dataset_speeds(
    wav_scp_lines: Sequence[Tuple[str, np.ndarray]],
    factors: Sequence[float] = (0.9, 1.0, 1.1),
) -> Sequence[Tuple[str, np.ndarray]]:
    """Expand (uid, wav) pairs with sp{factor}- prefixed copies
    (perturb_data_dir_speed naming: 'sp0.9-<uid>')."""
    out = []
    for uid, wav in wav_scp_lines:
        for f in factors:
            new_uid = uid if f == 1.0 else f"sp{f}-{uid}"
            out.append((new_uid, speed_perturb(wav, f)))
    return out


def apply_rir(wav: np.ndarray, rir: np.ndarray) -> np.ndarray:
    """Convolve with a room impulse response, power-normalized to the dry
    signal (preprocessor.py _convolve_rir)."""
    wet = np.convolve(wav, rir)[: len(wav)]
    p_dry = np.mean(wav**2) + 1e-12
    p_wet = np.mean(wet**2) + 1e-12
    return (wet * np.sqrt(p_dry / p_wet)).astype(wav.dtype)


def add_noise(
    wav: np.ndarray, noise: np.ndarray, snr_db: float, rng=None
) -> np.ndarray:
    """Mix in noise at the given SNR (preprocessor.py _add_noise); the noise
    is tiled/cropped to the utterance length."""
    rng = rng or np.random.default_rng(0)
    n = len(wav)
    if len(noise) < n:
        noise = np.tile(noise, n // len(noise) + 1)
    start = int(rng.integers(0, len(noise) - n + 1)) if len(noise) > n else 0
    noise = noise[start : start + n]
    p_sig = np.mean(wav**2) + 1e-12
    p_noise = np.mean(noise**2) + 1e-12
    scale = np.sqrt(p_sig / (p_noise * 10 ** (snr_db / 10.0)))
    return (wav + scale * noise).astype(wav.dtype)


class WavAugPreprocessor:
    """CommonPreprocessor speech-aug hooks: optional RIR convolution and
    additive noise at a random SNR, applied with given probabilities."""

    def __init__(
        self,
        inner=None,
        rirs: Sequence[np.ndarray] = (),
        noises: Sequence[np.ndarray] = (),
        rir_apply_prob: float = 1.0,
        noise_apply_prob: float = 1.0,
        noise_db_range: Tuple[float, float] = (13.0, 15.0),
        seed: int = 0,
    ):
        self.inner = inner
        self.rirs = list(rirs)
        self.noises = list(noises)
        self.rir_apply_prob = rir_apply_prob
        self.noise_apply_prob = noise_apply_prob
        self.noise_db_range = noise_db_range
        self.rng = np.random.default_rng(seed)

    def __call__(self, uid: str, data: dict) -> dict:
        if self.inner is not None:
            data = self.inner(uid, data)
        wav = data.get("speech")
        if wav is None or isinstance(wav, str):
            return data
        wav = np.asarray(wav)
        if self.rirs and self.rng.random() < self.rir_apply_prob:
            wav = apply_rir(wav, self.rirs[self.rng.integers(len(self.rirs))])
        if self.noises and self.rng.random() < self.noise_apply_prob:
            snr = self.rng.uniform(*self.noise_db_range)
            wav = add_noise(
                wav, self.noises[self.rng.integers(len(self.noises))], snr, self.rng
            )
        return {**data, "speech": wav}


class SpeedPerturbPreprocessor:
    """Wrap a preprocessor with random on-the-fly speed perturbation."""

    def __init__(self, inner=None, factors: Sequence[float] = (0.9, 1.0, 1.1), seed: int = 0):
        self.inner = inner
        self.factors = list(factors)
        self.rng = np.random.default_rng(seed)

    def __call__(self, uid: str, data: dict) -> dict:
        if self.inner is not None:
            data = self.inner(uid, data)
        if "speech" in data and not isinstance(data["speech"], str):
            f = self.factors[self.rng.integers(len(self.factors))]
            data = {**data, "speech": speed_perturb(np.asarray(data["speech"]), f)}
        return data
