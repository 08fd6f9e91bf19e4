"""Float32 rounding of the multichannel model's gradients, card against CPU,
and of the mask estimator's gradients against the CPU's float64 ones.

Two models in eval mode: ``tiny``, the model and ragged 4-channel batch of
tests/test_torch_gpu.py ``test_multichannel_model_on_the_card_matches_the_cpu``
(a Transformer encoder, so that a float64 copy runs: the whole model is
also held against float64), and ``full``, chip_smoke.py phase 32's
(train-1's Conformer 12 x 256 and decoder behind the multichannel frontend
at the JAX defaults, weights from seed 0) on its B = 2 x 10 s x 6-channel
batch.  For each parameter group (the mask estimator ``mc_frontend``,
``encoder``, ``decoder``, ``ctc_head``, the whole model) it prints the
relative distance (the root-sum-square of the differences over that of the
reference) of the card's float32 gradient from the CPU's and, for the tiny
model, of each from the CPU's float64 one; then, for the frontend alone
(chip_smoke.py ``mc_frontend_grads``: its features against a fixed random
cotangent), the same distances from float64 and every tensor whose card
gradient misses the CPU's by more than 1e-4 of its largest CPU value + 1e-6
of the largest, with the card's and the CPU's float32 distances (max abs)
from float64.  The JSON goes to ``--out``.

    python3 tools/mc_grad_rounding.py --out build/mc_grad_rounding.json

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

ARGS = ("speech", "speech_lengths", "text", "text_lengths")
GROUPS = ("mc_frontend.", "encoder.", "decoder.", "ctc_head.", "")


def grads(model, batch) -> dict:
    dev = next(model.parameters()).device
    dtype = next(model.parameters()).dtype
    model.zero_grad(set_to_none=True)
    model(*(batch[k].to(dev, dtype) if batch[k].is_floating_point() else batch[k].to(dev)
            for k in ARGS))[0].backward()
    return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}


def rel(a: dict, b: dict, prefix: str) -> float:
    keys = [k for k in b if k.startswith(prefix)]
    diff = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    return (diff / max(sum(float((b[k] ** 2).sum()) for k in keys), 1e-300)) ** 0.5


def frontend_study(name: str, cpu, batch) -> dict:
    import numpy as np

    from chip_smoke import mc_frontend_grads

    fe = cpu.mc_frontend
    speech, lens = batch["speech"], batch["speech_lengths"]
    with torch.no_grad():
        t = fe(speech[:1], lens[:1])[0].shape[1]
    cot = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (speech.shape[0], t, fe.cfg.n_mels)).astype(np.float32))
    g = {"card": mc_frontend_grads(copy.deepcopy(fe).cuda(), speech, lens, cot),
         "cpu": mc_frontend_grads(fe, speech, lens, cot),
         "f64": mc_frontend_grads(copy.deepcopy(fe).double(), speech, lens, cot)}
    out = {"card_vs_cpu": rel(g["card"], g["cpu"], ""),
           "card_vs_f64": rel(g["card"], g["f64"], ""),
           "cpu_vs_f64": rel(g["cpu"], g["f64"], ""), "misses": []}
    print(f"[{name}] the frontend alone: card vs CPU {out['card_vs_cpu']:.3e}, card vs float64 "
          f"{out['card_vs_f64']:.3e}, CPU vs float64 {out['cpu_vs_f64']:.3e}")
    floor = 1e-6 * max(x.abs().max().item() for x in g["cpu"].values())
    for k, ref in g["cpu"].items():
        tol = 1e-4 * ref.abs().max().item() + floor
        miss = (g["card"][k] - ref).abs().max().item()
        if miss > tol:
            card_d = (g["card"][k] - g["f64"][k]).abs().max().item()
            cpu_d = (ref - g["f64"][k]).abs().max().item()
            out["misses"].append({"tensor": k, "miss_over_tol": miss / tol, "card_vs_f64": card_d,
                                  "cpu_vs_f64": cpu_d, "tol": tol})
            print(f"[{name}]   {k}: misses by {miss / tol:.2f} x its tolerance; from float64 "
                  f"card {card_d:.3e}, CPU {cpu_d:.3e} (tol {tol:.3e})")
    return out


def study(name: str, cpu, batch, whole_f64: bool) -> dict:
    g = {"card": grads(copy.deepcopy(cpu).cuda(), batch), "cpu": grads(cpu, batch)}
    if whole_f64:
        g["f64"] = grads(copy.deepcopy(cpu).double(), batch)
    out = {"groups": {}}
    for prefix in GROUPS:
        row = {"card_vs_cpu": rel(g["card"], g["cpu"], prefix)}
        if whole_f64:
            row.update(card_vs_f64=rel(g["card"], g["f64"], prefix),
                       cpu_vs_f64=rel(g["cpu"], g["f64"], prefix))
        out["groups"][prefix or "whole"] = row
        print(f"[{name}] {prefix or 'whole model'}: " + ", ".join(
            f"{k.replace('_', ' ')} {v:.3e}" for k, v in row.items()))
    out["frontend"] = frontend_study(name, cpu, batch)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--skip-full", action="store_true", help="the tiny model only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mc_grad_rounding: needs a CUDA card", file=sys.stderr)
        return 2
    from llm_guided_asr_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    from test_torch_gpu import multichannel_model_and_batch

    result = {"tiny": study("tiny", *multichannel_model_and_batch()[:2], whole_f64=True)}
    if not args.skip_full:
        import chip_smoke

        cpu = chip_smoke.build_mc_asr().cpu().eval()
        batch = {k: v.cpu() for k, v in chip_smoke.train_batch(
            chip_smoke.GRAD_B, seed=5, channels=chip_smoke.MC_CHANNELS).items()}
        result["full"] = study("full", cpu, batch, whole_f64=False)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
