"""Transducer inference entry (counterpart of llm_guided_asr_tpu/bin/asr_transducer_inference.py).

The JAX shim hands its arguments to asr_inference, which dispatches on the
model's joint network.  The port's Speech2Text does the same for a
transducer with its weights loaded:

    s2t = Speech2Text(TransducerModel(cfg), beam_size=5)  # 1: greedy
    [(token_ids, hyp)] = s2t(waveform)

The command line comes with the task layer, which is not ported yet.
"""

from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

__all__ = ["Speech2Text"]
