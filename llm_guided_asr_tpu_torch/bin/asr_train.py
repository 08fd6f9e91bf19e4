#!/usr/bin/env python3
"""ASR training CLI (counterpart of llm_guided_asr_tpu/bin/asr_train.py;
espnet2/bin/asr_train.py analog):

    python -m llm_guided_asr_tpu_torch.bin.asr_train --config conf/train.yaml \
        [--collect_stats true] [--key value ...] [--device cpu]
"""


def main(cmd=None):
    import sys

    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask

    return ASRTask.main(cmd if cmd is not None else sys.argv[1:])


if __name__ == "__main__":
    main()
