#!/usr/bin/env python3
"""Multi-task training CLI (counterpart of llm_guided_asr_tpu/bin/train.py):
``--task asr|lm|st``.  The JAX package's other tasks (the generic model
zoo) raise: ROADMAP Queue 1 item 12."""


def main(cmd=None):
    import sys

    args = list(cmd if cmd is not None else sys.argv[1:])
    task = None
    for i, a in enumerate(args):
        if a == "--task" and i + 1 < len(args):
            task = args[i + 1]
        elif a.startswith("--task="):
            task = a.split("=", 1)[1]
    if task == "asr":
        from llm_guided_asr_tpu_torch.tasks.asr import ASRTask

        return ASRTask.main(_strip_task(args))
    if task == "lm":
        from llm_guided_asr_tpu_torch.tasks.lm import LMTask

        return LMTask.main(_strip_task(args))
    if task == "st":
        from llm_guided_asr_tpu_torch.tasks.st import STTask

        return STTask.main(_strip_task(args))
    raise NotImplementedError(f"--task {task} is not ported yet (ROADMAP Queue 1 item 12)")


def _strip_task(args):
    out = []
    i = 0
    while i < len(args):
        if args[i] == "--task":
            i += 2
        elif args[i].startswith("--task="):
            i += 1
        else:
            out.append(args[i])
            i += 1
    return out


if __name__ == "__main__":
    main()
