#!/usr/bin/env python3
"""Transducer training CLI (counterpart of llm_guided_asr_tpu/bin/asr_transducer_train.py;
espnet2/bin/asr_transducer_train.py): ``ASRTask`` with ``--model
transducer`` put before the caller's arguments.

    python -m llm_guided_asr_tpu_torch.bin.asr_transducer_train --config conf/train.yaml \
        [--key value ...] [--device cpu]
"""


def main(cmd=None):
    import sys

    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask

    return ASRTask.main(["--model", "transducer"] + list(cmd if cmd is not None else sys.argv[1:]))


if __name__ == "__main__":
    main()
