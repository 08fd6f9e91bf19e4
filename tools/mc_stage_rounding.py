"""Where the multichannel frontend's float32 rounding comes from, stage by
stage: the card's and the CPU's float32 against the CPU's float64.

For chip_smoke.py phase 31's frontend (the JAX defaults, six channels of
its seeded 10 s waveforms, B = 2; weights from seed 0) it runs the
frontend's stages one by one: the complex STFT, WPE, the masks (the BiLSTM
estimator), MVDR and the log-mel features, each from the same device's
previous stage, and prints each stage's largest deviation from float64 over
the reference's largest magnitude, on the card and on the CPU.  Variants
isolate a stage: on the card the masks from the plain PyTorch loop instead
of the LSTM kernels, and on both WPE or MVDR in complex64 as the JAX
package computes them (the port takes their statistics and solves in
complex128, ops/beamformer.py).  Before it, one
complex64 product of the WPE Gram's shape ([257, 30, 1251] by its
conjugate transpose) and one batched 30 x 30 solve, each on the card and
the CPU, against complex128.

    python3 tools/mc_stage_rounding.py

Needs a CUDA card.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().to(want.dtype), want.detach().cpu()
    return float((got - want).abs().max() / want.abs().max())


def wpe_complex64(y, taps, delay, iterations, eps=1e-6):
    """WPE in y's complex64 throughout, as the JAX package computes it."""
    from llm_guided_asr_tpu_torch.ops.beamformer import _stack_taps, _weighted_gram

    ytil = _stack_taps(y, taps, delay)
    eye = torch.eye(ytil.shape[-2], dtype=y.dtype, device=y.device)
    x = y
    for _ in range(iterations):
        inv_power = (1.0 / ((x.abs() ** 2).mean(dim=-2) + eps)).to(y.dtype)
        g = torch.linalg.solve(_weighted_gram(ytil, inv_power, ytil) + eps * eye,
                               _weighted_gram(ytil, inv_power, y))
        x = y - g.conj().transpose(-1, -2) @ ytil
    return x


def mvdr_complex64(y, mask_speech, mask_noise, ref_channel, eps=1e-6):
    """MVDR in y's complex64 throughout, as the JAX package computes it."""
    from llm_guided_asr_tpu_torch.ops.beamformer import psd_matrix

    phi_s, phi_n = psd_matrix(y, mask_speech, eps), psd_matrix(y, mask_noise, eps)
    eye = torch.eye(y.shape[-2], dtype=y.dtype, device=y.device)
    num = torch.linalg.solve(phi_n + eps * eye, phi_s)
    w = num[..., ref_channel] / (num.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None] + eps)
    return (w.conj()[..., None, :] @ y)[..., 0, :]


def stages(fe, speech, lstm_plain=False, wpe32=False, mvdr32=False) -> dict:
    """The frontend's stages on ``fe``'s device and dtype."""
    from llm_guided_asr_tpu_torch.ops import beamformer as bf
    from llm_guided_asr_tpu_torch.ops import frontend as fm
    from llm_guided_asr_tpu_torch.ops import lstm as lk

    c = fe.cfg
    dev, dtype = next(fe.parameters()).device, next(fe.parameters()).dtype
    speech = speech.to(dev, dtype)
    b, s, ch = speech.shape
    out = {}
    with torch.no_grad():
        spec = fm.stft(speech.movedim(-1, 1).reshape(b * ch, s), c.n_fft, c.win_length,
                       c.hop_length, c.center, c.window)
        t, f = spec.shape[1], spec.shape[2]
        y = out["stft"] = spec.reshape(b, ch, t, f).permute(0, 3, 1, 2)
        wpe = wpe_complex64 if wpe32 else bf.wpe_dereverb
        y = wpe(y, c.wpe_taps, c.wpe_delay, c.wpe_iterations)
        out["wpe"] = y
        lm_globals = fm.lstm_stack.__globals__  # models/lm.py, where lstm_stack looks it up
        if lstm_plain:
            lm_globals["lstm_recurrence"] = lk.lstm_recurrence_plain
        try:
            m_s, m_n = fe.masks(y)
        finally:
            lm_globals["lstm_recurrence"] = lk.lstm_recurrence
        out["mask_speech"], out["mask_noise"] = m_s, m_n
        enh = (mvdr_complex64 if mvdr32 else bf.mvdr_beamform)(y, m_s, m_n, c.ref_channel)
        out["mvdr"] = enh
        power = (enh.real ** 2 + enh.imag ** 2).transpose(1, 2)
        out["features"] = fm.logmel_from_power(power, c.fs, c.n_fft, c.n_mels, c.fmin, c.fmax,
                                               c.htk)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("mc_stage_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    from llm_guided_asr_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    import chip_smoke

    print(f"[stages] TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}; float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}; {chip_smoke.nvidia_smi_name_power()}")
    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.standard_normal((257, 30, 1251))
                          + 1j * rng.standard_normal((257, 30, 1251))).astype(np.complex64))
    want = a.to(torch.complex128) @ a.to(torch.complex128).conj().transpose(-1, -2)
    for name, dev in (("card", "cuda"), ("CPU", "cpu")):
        x = a.to(dev)
        print(f"[stages] complex64 Gram [257, 30, 1251] on the {name}: "
              f"{rel(x @ x.conj().transpose(-1, -2), want):.3e} of float64's largest")
    r = (want[:, :, :] / 1251 + 1e-3 * torch.eye(30, dtype=torch.complex128))
    rhs = torch.from_numpy((rng.standard_normal((257, 30, 6))
                            + 1j * rng.standard_normal((257, 30, 6))).astype(np.complex128))
    sol = torch.linalg.solve(r, rhs)
    for name, dev in (("card", "cuda"), ("CPU", "cpu")):
        got = torch.linalg.solve(r.to(dev, torch.complex64), rhs.to(dev, torch.complex64))
        print(f"[stages] complex64 solve [257, 30, 30] on the {name}: {rel(got, sol):.3e}")

    model = chip_smoke.build_mc_asr().eval()
    fe_card = model.mc_frontend
    fe_cpu = copy.deepcopy(fe_card).cpu()
    fe_64 = copy.deepcopy(fe_cpu).double()
    batch = chip_smoke.train_batch(2, seed=5, channels=chip_smoke.MC_CHANNELS)
    speech = batch["speech"].cpu()
    ref = stages(fe_64, speech)
    runs = {"card": stages(fe_card, speech), "CPU": stages(fe_cpu, speech),
            "card, plain LSTM loop": stages(fe_card, speech, lstm_plain=True),
            "card, WPE in complex64": stages(fe_card, speech, wpe32=True),
            "CPU, WPE in complex64": stages(fe_cpu, speech, wpe32=True),
            "card, MVDR in complex64": stages(fe_card, speech, mvdr32=True),
            "CPU, MVDR in complex64": stages(fe_cpu, speech, mvdr32=True)}
    for name, out in runs.items():
        print(f"[stages] {name}: " + ", ".join(f"{k} {rel(v, ref[k]):.3e}"
                                               for k, v in out.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
