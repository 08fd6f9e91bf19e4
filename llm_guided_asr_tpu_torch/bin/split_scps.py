#!/usr/bin/env python3
"""Split scp files into N balanced shards (counterpart of
llm_guided_asr_tpu/bin/split_scps.py; espnet2/bin/split_scps.py).

The pipeline's stage 12 splits its decode jobs with it (``--scps wav.scp
--num_splits N --output_dir split``): writes <output_dir>/<name>.{1..N}
and ``num_splits``.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

logger = logging.getLogger(__name__)


def split_scps(scps, num_splits: int, output_dir: str):
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if num_splits < 1:
        raise ValueError("num_splits must be >= 1")
    key_sets = None
    for scp in scps:
        lines = [ln for ln in Path(scp).read_text().splitlines() if ln.strip()]
        keys = [ln.split(maxsplit=1)[0] for ln in lines]
        if key_sets is None:
            key_sets = keys
        # shard by position in the FIRST scp's key order, so that parallel
        # files stay aligned (split_scps.py keeps line correspondence)
        order = {k: i for i, k in enumerate(key_sets)}
        lines.sort(key=lambda ln: order.get(ln.split(maxsplit=1)[0], 1 << 30))
        name = Path(scp).name
        for n in range(num_splits):
            shard = lines[n::num_splits]
            (out / f"{name}.{n + 1}").write_text("\n".join(shard) + ("\n" if shard else ""))
    (out / "num_splits").write_text(f"{num_splits}\n")
    logger.info(f"split {len(scps)} scp file(s) into {num_splits} shards -> {out}")


def main(cmd=None):
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "scps": [], "num_splits": 1, "output_dir": "split",
    })
    logging.basicConfig(level=logging.INFO)
    scps = config["scps"]
    if isinstance(scps, str):
        scps = [scps]
    split_scps(scps, int(config["num_splits"]), config["output_dir"])


if __name__ == "__main__":
    main()
