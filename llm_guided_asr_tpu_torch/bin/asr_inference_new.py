#!/usr/bin/env python3
"""Contextual-biasing inference entry (counterpart of
llm_guided_asr_tpu/bin/asr_inference_new.py; espnet2/bin/asr_inference_new.py
shim).  asr_inference carries the per-utterance biasing words itself
(``--biasing_words_file``); this name is kept for the reference's CLI."""


def main(cmd=None):
    import sys

    from llm_guided_asr_tpu_torch.bin.asr_inference import main as inf_main

    return inf_main(list(cmd if cmd is not None else sys.argv[1:]))


if __name__ == "__main__":
    main()
