#!/usr/bin/env python3
"""Model packaging: config, weights and stats in one archive (counterpart of
llm_guided_asr_tpu/bin/pack.py).

Rebuild of espnet2/bin/pack.py and the espnet_model_zoo side
(Speech2Text.from_pretrained, asr_inference.py:678-706): :func:`pack`
zips an experiment's artifacts with a ``meta.json`` manifest, and
``Speech2Text.from_packed`` (bin/asr_inference.py) rebuilds a recognizer
from the archive with no experiment directory.  The weights keep their
format's suffix in the archive (``model.pth``, or ``model.msgpack`` for a
JAX package checkpoint), so that the loader reads them as what they are.

    python -m llm_guided_asr_tpu_torch.bin.pack --output model.zip \
        --asr_train_config exp/config.yaml --asr_model_file exp/valid.acc.ave.pth
"""

from __future__ import annotations

import json
import logging
import sys
import zipfile
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)

MANIFEST = "meta.json"


def pack(output: str, asr_train_config: str, asr_model_file: str,
         stats_file: Optional[str] = None, extra: Optional[Dict[str, str]] = None) -> Path:
    out = Path(output)
    out.parent.mkdir(parents=True, exist_ok=True)
    files = {
        "asr_train_config": ("config.yaml", asr_train_config),
        "asr_model_file": ("model" + Path(asr_model_file).suffix, asr_model_file),
    }
    if stats_file:
        files["stats_file"] = ("feats_stats.npz", stats_file)
    for key, path in (extra or {}).items():
        files[key] = (Path(path).name, path)
    manifest = {key: arc for key, (arc, _) in files.items()}
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(MANIFEST, json.dumps(manifest, indent=1))
        for key, (arc, path) in files.items():
            z.write(path, arc)
    logger.info(f"packed {len(files)} files -> {out}")
    return out


def unpack(archive: str, out_dir: str) -> Dict[str, str]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(archive) as z:
        z.extractall(out)
        manifest = json.loads((out / MANIFEST).read_text())
    return {key: str(out / arc) for key, arc in manifest.items()}


def main(cmd=None):
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "output": "model.zip",
        "asr_train_config": None,
        "asr_model_file": None,
        "stats_file": None,
    })
    logging.basicConfig(level=logging.INFO)
    return pack(config["output"], config["asr_train_config"], config["asr_model_file"],
                config.get("stats_file"))


if __name__ == "__main__":
    main()
