#!/usr/bin/env python3
"""LM training CLI (counterpart of llm_guided_asr_tpu/bin/lm_train.py;
espnet2/bin/lm_train.py analog)."""


def main(cmd=None):
    import sys

    from llm_guided_asr_tpu_torch.tasks.lm import LMTask

    return LMTask.main(cmd if cmd is not None else sys.argv[1:])


if __name__ == "__main__":
    main()
