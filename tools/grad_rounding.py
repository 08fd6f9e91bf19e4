"""Float32 rounding of the pretrained-choice models' gradients, card
against CPU, each against the CPU's float64 gradient.

The models are those of tests/test_torch_gpu.py
``test_pretrained_choices_on_the_card_match_the_cpu`` (tiny widths, weights
from a seed, a ragged batch of three), in eval mode.  For each seed (the
weights' seed s, the batch's s + 2; the test takes seed 0) and with cuDNN's
algorithm free or pinned (``cudnn.deterministic``), every tensor whose card
gradient misses the CPU's by more than the test's tolerance (1e-4 of its
largest CPU value + 1e-6 of the model's largest) is listed with the card's
and the CPU's float32 distances from the CPU's float64 gradient, their
ratio, the card's float64 gradient's distance from the CPU's, and beside
it the same for the CTC loss's gradient alone at the CPU model's logits
(the loss's backward on each device against float64).  The JSON
goes to ``--out``; the largest ratio of each setting is printed last.

    python3 tools/grad_rounding.py --seeds 6 --out build/grad_rounding.json

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from test_torch_gpu import _hf_config  # noqa: E402

from llm_guided_asr_tpu_torch.tasks import asr as tasr  # noqa: E402

KINDS = ("ssl", "hubert_hf", "whisper_hf", "sinc", "bert", "fused")
ARGS = ("speech", "speech_lengths", "text", "text_lengths")


def batch_of(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"speech": torch.from_numpy((rng.standard_normal((3, 16000)) * 0.1)
                                       .astype(np.float32)),
            "speech_lengths": torch.tensor([16000, 12000, 7000]),
            "text": torch.from_numpy(rng.integers(1, 29, (3, 6))),
            "text_lengths": torch.tensor([6, 4, 5])}


def grads(model, batch) -> dict:
    dev = next(model.parameters()).device
    model.zero_grad(set_to_none=True)
    dtype = next(model.parameters()).dtype
    model(*(batch[k].to(dev, dtype) if batch[k].is_floating_point() else batch[k].to(dev)
            for k in ARGS))[0].backward()
    return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()
            if p.grad is not None}


def ctc_rounding(model, batch) -> dict:
    """The CTC loss's gradient at the CPU model's CTC logits (float32), on
    the card and on the CPU, each against the same loss in float64: the
    part of a miss that the loss's own backward makes."""
    from llm_guided_asr_tpu_torch.ops.losses import ctc_loss

    with torch.no_grad():
        enc, lens = model.encode(batch["speech"], batch["speech_lengths"])
        logits = model.ctc_logits(enc)
    out = {}
    for name, dev, dtype in (("cpu", "cpu", torch.float32), ("card", "cuda", torch.float32),
                             ("f64", "cpu", torch.float64)):
        x = logits.to(dev, dtype).detach().requires_grad_(True)
        ctc_loss(x, lens.to(dev), batch["text"].to(dev), batch["text_lengths"].to(dev)).backward()
        out[name] = x.grad.cpu().double()
    card = (out["card"] - out["f64"]).abs().max().item()
    cpu = (out["cpu"] - out["f64"]).abs().max().item()
    return {"ctc_card_f64": card, "ctc_cpu_f64": cpu, "ctc_ratio": card / cpu}


def misses(kind: str, seed: int, root: Path) -> list:
    config, _ = _hf_config(kind, root)
    config = {**tasr.ASRTask.get_default_config(), **config}
    cpu = tasr.init_model_variables(tasr.build_model(config, "cpu"), config, seed).eval()
    gpu = tasr.build_model(config, "cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    batch = batch_of(seed + 2)
    want, got = grads(cpu, batch), grads(gpu, batch)
    floor = 1e-6 * max(g.abs().max().item() for g in want.values())
    out, exact = [], None
    for name, ref in want.items():
        tol = 1e-4 * ref.abs().max().item() + floor
        miss = (got[name] - ref).abs().max().item()
        if miss > tol:
            row = {"kind": kind, "seed": seed, "tensor": name, "miss": miss, "tol": tol,
                   "card_f64": None, "cpu_f64": None, "ratio": None}
            try:
                exact = exact or (grads(copy.deepcopy(cpu).double(), batch),
                                  grads(copy.deepcopy(gpu).double(), batch))
            except (TypeError, RuntimeError) as e:  # rel_attention, the log-mel frontend: float32
                row["no_float64"] = str(e)
            else:
                truth = exact[0][name]
                row["card_f64"] = (got[name] - truth).abs().max().item()
                row["cpu_f64"] = (ref - truth).abs().max().item()
                row["ratio"] = row["card_f64"] / row["cpu_f64"]
                row["f64_card_vs_cpu"] = (exact[1][name] - truth).abs().max().item()
            out.append(row)
    if out:
        ctc = ctc_rounding(cpu, batch)
        for row in out:
            row.update(ctc)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--out", default="build/grad_rounding.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_rounding: needs a CUDA card", file=sys.stderr)
        return 1
    result = {}
    for pinned in (False, True):
        torch.backends.cudnn.deterministic = pinned
        torch.backends.cudnn.benchmark = False
        rows, runs = [], 0
        with tempfile.TemporaryDirectory() as tmp:
            for kind in KINDS:
                for seed in range(a.seeds):
                    rows += misses(kind, seed, Path(tmp))
                    runs += 1
        for r in rows:
            f64 = (f"from float64: card {r['card_f64']:.3e}, CPU {r['cpu_f64']:.3e}, ratio "
                   f"{r['ratio']:.2f} (float64 on the card vs the CPU: "
                   f"{r['f64_card_vs_cpu']:.3e})" if r["ratio"] is not None
                   else "no float64 model")
            print(f"deterministic={pinned} {r['kind']} seed {r['seed']} {r['tensor']}: miss "
                  f"{r['miss']:.3e} > tol {r['tol']:.3e}; {f64}; the CTC loss's own gradient "
                  f"at the logits from float64: card {r['ctc_card_f64']:.3e}, CPU "
                  f"{r['ctc_cpu_f64']:.3e}, ratio {r['ctc_ratio']:.2f}")
        worst = max((r["ratio"] for r in rows if r["ratio"] is not None), default=None)
        print(f"deterministic={pinned}: {len(rows)} tensors missed in {runs} runs; largest "
              f"card/CPU ratio of distances from float64: {worst}")
        result[f"deterministic={pinned}"] = {"runs": runs, "misses": rows, "max_ratio": worst}
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
