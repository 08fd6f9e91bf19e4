#!/usr/bin/env python3
"""ST training CLI (counterpart of llm_guided_asr_tpu/bin/st_train.py;
espnet2/bin/st_train.py analog):

    python -m llm_guided_asr_tpu_torch.bin.st_train --config conf/train_st.yaml \
        [--key value ...] [--device cpu]
"""


def main(cmd=None):
    import sys

    from llm_guided_asr_tpu_torch.tasks.st import STTask

    return STTask.main(cmd if cmd is not None else sys.argv[1:])


if __name__ == "__main__":
    main()
