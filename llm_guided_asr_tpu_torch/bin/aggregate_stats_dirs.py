#!/usr/bin/env python3
"""Merge collect-stats output directories (counterpart of
llm_guided_asr_tpu/bin/aggregate_stats_dirs.py; espnet2/bin/aggregate_stats_dirs.py).

When collect-stats ran sharded (one directory a job), each split's
``feats_stats.npz`` (count, sum, sum_square) is summed and its shape files
are concatenated in the order of the input directories.

    python -m llm_guided_asr_tpu_torch.bin.aggregate_stats_dirs \
        --input_dir '[stats.1, stats.2]' --output_dir stats
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)


def aggregate(input_dirs: Sequence[str], output_dir: str) -> None:
    out = Path(output_dir)
    splits = set()
    for d in input_dirs:
        splits.update(p.name for p in Path(d).iterdir() if p.is_dir())
    for split in sorted(splits):
        sdir = out / split
        sdir.mkdir(parents=True, exist_ok=True)
        count, s, sq = 0, None, None
        shape_lines: dict = {}
        for d in input_dirs:
            src = Path(d) / split
            npz = src / "feats_stats.npz"
            if npz.exists():
                z = np.load(npz)
                count += int(z["count"])
                s = z["sum"] if s is None else s + z["sum"]
                sq = z["sum_square"] if sq is None else sq + z["sum_square"]
            for shp in src.glob("*_shape"):
                shape_lines.setdefault(shp.name, []).append(shp.read_text())
        if s is not None:
            np.savez(sdir / "feats_stats.npz", count=count, sum=s, sum_square=sq)
        for name, chunks in shape_lines.items():
            (sdir / name).write_text("".join(chunks))
        logger.info(f"aggregated[{split}]: {len(input_dirs)} dirs, {count} frames")


def main(cmd=None) -> None:
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "input_dir": [], "output_dir": None,
    })
    logging.basicConfig(level=logging.INFO)
    dirs = config["input_dir"]
    aggregate([dirs] if isinstance(dirs, str) else dirs, config["output_dir"])


if __name__ == "__main__":
    main()
