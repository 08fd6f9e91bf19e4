#!/usr/bin/env python3
"""Transducer inference entry (counterpart of llm_guided_asr_tpu/bin/asr_transducer_inference.py).

The JAX shim hands its arguments to asr_inference, which dispatches on the
model's joint network; so does the port's (``--beam_size 1``: greedy).
From a model object:

    s2t = Speech2Text.from_model(TransducerModel(cfg), beam_size=5)
    [(token_ids, hyp)] = s2t(waveform)
"""

from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.bin.asr_inference import main as inf_main


def main(cmd=None):
    import sys

    return inf_main(list(cmd if cmd is not None else sys.argv[1:]))


__all__ = ["Speech2Text", "main"]

if __name__ == "__main__":
    main()
