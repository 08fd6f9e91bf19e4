"""Local Hugging Face checkpoint directories, read without ``transformers``.

The port's counterpart of what the JAX package asks of ``AutoConfig`` and
``AutoModel.from_pretrained`` for a local directory
(models/ssl_encoders.py load_pretrained_encoder, models/hf_encoder.py
load_hf_postencoder_params, tasks/asr.py): :func:`read_hf_config` parses
``config.json`` into a plain dict, and :func:`load_hf_state_dict` reads the
weights as a ``{name: CPU tensor}`` state dict from ``model.safetensors``,
the shards of ``model.safetensors.index.json``, ``pytorch_model.bin`` or the
shards of ``pytorch_model.bin.index.json``, in that order of preference
(as ``from_pretrained`` prefers safetensors).  No hub lookup: a directory
that holds none of them raises.

The safetensors reader is the standard library and numpy: an 8-byte
little-endian header length, a JSON header of ``{name: {"dtype", "shape",
"data_offsets": [begin, end]}}`` (and an optional ``__metadata__``), then
the raw little-endian bytes.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Iterator, List, Tuple, Union

import numpy as np
import torch

# safetensors dtype -> (numpy type the bytes are read as, torch type)
_SAFETENSORS_TYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def _read_header(f) -> Tuple[Dict[str, Any], int]:
    """The JSON header of an open ``.safetensors`` file and the offset of
    its data; ``__metadata__`` dropped."""
    (n_header,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n_header))
    header.pop("__metadata__", None)
    return header, 8 + n_header


def iter_safetensors(path: Union[str, Path]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor in the file's type) of each tensor of a
    ``.safetensors`` file, read one at a time: each tensor's bytes by a
    seek and one read; BF16 is read as 16-bit integers and viewed as
    torch.bfloat16, bit for bit."""
    with open(path, "rb") as f:
        header, data_start = _read_header(f)
        for name, info in header.items():
            if info["dtype"] not in _SAFETENSORS_TYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
            np_type, torch_type = _SAFETENSORS_TYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            f.seek(data_start + begin)
            arr = np.frombuffer(f.read(end - begin), dtype=np.dtype(np_type).newbyteorder("<"))
            t = torch.from_numpy(arr.astype(np_type, copy=True)).reshape(info["shape"])
            yield name, (t.view(torch_type) if torch_type == torch.bfloat16 else t)


def load_safetensors(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor in the file's type}."""
    return dict(iter_safetensors(path))


def _shards(model_dir: Path, index_name: str) -> List[Path]:
    weight_map = json.loads((model_dir / index_name).read_text())["weight_map"]
    return [model_dir / f for f in dict.fromkeys(weight_map.values())]


def checkpoint_files(model_dir: Union[str, Path]) -> List[Path]:
    """The ``.safetensors`` files of a checkpoint directory: the shards that
    ``model.safetensors.index.json`` names, in order, or ``model.safetensors``."""
    model_dir = Path(model_dir)
    if (model_dir / "model.safetensors.index.json").is_file():
        return _shards(model_dir, "model.safetensors.index.json")
    single = model_dir / "model.safetensors"
    if not single.is_file():
        raise FileNotFoundError(f"no safetensors checkpoint under {model_dir}")
    return [single]


def read_hf_config(model_dir: Union[str, Path]) -> Dict[str, Any]:
    """A checkpoint directory's ``config.json`` as a plain dict."""
    path = Path(model_dir) / "config.json"
    if not path.is_file():
        raise FileNotFoundError(f"no config.json under {model_dir}")
    return json.loads(path.read_text())


def load_hf_state_dict(model_dir: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of a local checkpoint directory, by its name in the
    file, on the CPU in the file's type: safetensors (one file or the
    shards of its index) where the directory has them, else
    ``pytorch_model.bin`` (or the shards of its index) through
    ``torch.load(weights_only=True)``."""
    model_dir = Path(model_dir)
    if (model_dir / "model.safetensors.index.json").is_file() or (
            model_dir / "model.safetensors").is_file():
        sd: Dict[str, torch.Tensor] = {}
        for path in checkpoint_files(model_dir):
            sd.update(iter_safetensors(path))
        return sd
    if (model_dir / "pytorch_model.bin.index.json").is_file():
        files = _shards(model_dir, "pytorch_model.bin.index.json")
    elif (model_dir / "pytorch_model.bin").is_file():
        files = [model_dir / "pytorch_model.bin"]
    else:
        raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin under {model_dir}")
    sd = {}
    for path in files:
        sd.update(torch.load(path, map_location="cpu", weights_only=True))
    return sd


def strip_prefix(sd: Dict[str, torch.Tensor], prefixes) -> Dict[str, torch.Tensor]:
    """``sd`` with the first of ``prefixes`` that some key starts with taken
    off those keys (the base-model prefix of a task head's checkpoint, as
    ``AutoModel.from_pretrained`` drops it); keys without it are dropped."""
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return dict(sd)
