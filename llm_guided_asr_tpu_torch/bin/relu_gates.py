"""Float32 against float64 gradients of an ASRModel's attention decoder, and
the ReLU gates that float32 rounding flips.

The model is chip_smoke.py phase 25's: the Conformer (12 x 256, vocab 5000)
with the named decoder, weights from each of ``--seeds`` seeds
(``init_weights``), eval mode; the batch is 2 x 10 s of seeded noise with 24
seeded tokens each, encoded once.  For each seed it prints the decoder's
attention-loss gradients, each as its largest move over the smoke check's
tolerance (1e-4 of the tensor's largest value + 1e-6):

- float32 against float64 at the same encoder rows;
- float32, and float64, after the rows move by ``--delta`` (Gaussian);

and the gates of the decoder's feed-forward ReLUs whose sign differs between
float32 and float64 at the same rows, with their float64 and float32
pre-activations, and the number that differ in float32 between the rows and
the moved rows.

    python -m llm_guided_asr_tpu_torch.bin.relu_gates --device cpu \\
        --decoders dynamicconv,lightconv,transformer --seeds 8
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from llm_guided_asr_tpu_torch.convert import init_weights
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.transformer import PositionwiseFeedForward
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.losses import add_sos_eos, label_smoothing_loss
from llm_guided_asr_tpu_torch.utils.device import resolve_device

DECODERS = {
    "rnn": dict(num_blocks=1, linear_units=320),
    "lightconv": dict(num_blocks=6, attention_heads=4, linear_units=2048),
    "dynamicconv": dict(num_blocks=6, attention_heads=4, linear_units=2048),
    "s4": dict(num_blocks=6, attention_heads=4, linear_units=2048),
    "transformer": dict(num_blocks=6, attention_heads=4, linear_units=2048),
}


def build(kind: str, seed: int, device) -> ASRModel:
    enc = ConformerConfig(output_size=256, attention_heads=4, linear_units=1024, num_blocks=12,
                          macaron_style=True, use_cnn_module=True, cnn_module_kernel=31)
    cfg = ASRModelConfig(
        vocab_size=5000, frontend=FrontendConfig(), normalize="utterance_mvn",
        encoder_type="conformer", encoder=enc, decoder_type=kind,
        decoder=TransformerDecoderConfig(**DECODERS[kind]), ctc_weight=0.3)
    return init_weights(ASRModel(cfg, device=device), seed=seed).eval()


def decoder_grads(model, enc, lens, ys_in, ys_out, ys_lens):
    """The attention loss's decoder gradients and the pre-activations of
    every feed-forward ReLU in the decoder."""
    gates = []
    hooks = [m.w_1.register_forward_hook(lambda mod, i, out: gates.append(out.detach()))
             for m in model.decoder.modules() if isinstance(m, PositionwiseFeedForward)]
    model.zero_grad(set_to_none=True)
    cfg = model.cfg
    logits = model.decoder_logits(enc, lens, ys_in, ys_lens)
    label_smoothing_loss(logits, ys_out, cfg.lsm_weight, cfg.ignore_id,
                         cfg.length_normalized_loss).backward()
    for h in hooks:
        h.remove()
    return {n: q.grad.double() for n, q in model.decoder.named_parameters()}, gates


def worst(got: dict, want: dict) -> tuple:
    """(largest move over its tolerance, the tensor)."""
    return max(((got[n] - ref).abs().max().item() / (1e-4 * ref.abs().max().item() + 1e-6), n)
               for n, ref in want.items())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--decoders", default="dynamicconv,lightconv")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--delta", type=float, default=6e-6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    rng = np.random.default_rng(5)
    samples = 160000
    speech = torch.from_numpy((rng.standard_normal((2, samples)) * 0.1).astype(np.float32)).to(dev)
    speech_lens = torch.full((2,), samples, device=dev)
    text = torch.from_numpy(rng.integers(1, 4999, (2, 24))).to(dev)
    text_lens = torch.full((2,), 24, device=dev)
    for kind in args.decoders.split(","):
        for seed in range(args.seeds):
            model = build(kind, seed, dev)
            cfg = model.cfg
            with torch.no_grad():
                enc, lens = model.encode(speech, speech_lens)
            ys_in, ys_out = add_sos_eos(text, text_lens, cfg.sos_id, cfg.eos_id, cfg.ignore_id)
            moved = enc + torch.randn(enc.shape, generator=torch.Generator().manual_seed(seed)
                                      ).to(dev) * args.delta
            batch = (lens, ys_in, ys_out, text_lens + 1)
            g32, z32 = decoder_grads(model, enc, *batch)
            g32_moved, z32_moved = decoder_grads(model, moved, *batch)
            m64 = copy.deepcopy(model).double()
            g64, z64 = decoder_grads(m64, enc.double(), *batch)
            g64_moved, _ = decoder_grads(m64, moved.double(), *batch)
            flips = [(i, a[(a > 0) != (b > 0)].tolist(), b[(a > 0) != (b > 0)].tolist())
                     for i, (a, b) in enumerate(zip(z64, z32)) if ((a > 0) != (b > 0)).any()]
            n_moved = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(z32, z32_moved))
            print(f"{kind} seed {seed}: f32 vs f64 at the same rows {worst(g32, g64)[0]:.2f} "
                  f"of the tolerance ({worst(g32, g64)[1]}); rows moved by {args.delta:g}: "
                  f"f32 {worst(g32_moved, g32)[0]:.2f} ({n_moved} gates flipped), "
                  f"f64 {worst(g64_moved, g64)[0]:.3f}; "
                  f"ReLU gates of {sum(z.numel() for z in z64)} flipped by f32 (feed-forward "
                  f"layer, f64 z, f32 z): {flips}", flush=True)


if __name__ == "__main__":
    main()
