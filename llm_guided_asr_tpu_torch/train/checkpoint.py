"""Checkpoint store: save/resume, n-best retention, weight averaging
(counterpart of llm_guided_asr_tpu/train/checkpoint.py).

Rebuild of the reference checkpoint discipline (trainer.py:408-540 and
main_funcs/average_nbest_models.py:14), in ESPnet's own ``.pth`` files
(``torch.save`` of plain dicts of tensors):
- every epoch: ``checkpoint.pth`` (the full train state: the model's state
  dict, the optimizer's, the update count and the plateau scale) +
  ``{n}epoch.pth`` (the model's state dict) + the ``latest.pth`` and
  ``{phase}.{key}.best.pth`` symlinks;
- n-best pruning keeps the union of the best epochs per criterion and the
  latest;
- final artifact ``{phase}.{key}.ave_{n}best.pth`` = the mean of the n best
  epochs' floating tensors (the decode artifact, e.g.
  valid.acc.ave_10best.pth).

Reading also takes the JAX package's flax ``.msgpack`` files (its
``{n}epoch.msgpack`` and ``ave_{n}best.msgpack``): :func:`read_msgpack` is
the port's own reader of flax's msgpack encoding (maps, arrays, strings,
numbers and flax's ndarray, scalar and complex ext types, and its chunked
arrays), and :func:`load` maps such a tree to the port's state-dict names
(convert.params_from_msgpack).  The port writes ``.pth`` only.

``exclude_prefixes`` leaves subtrees out of every file: the frozen LLM
(trainer.py:408-417 strips decoder.llm.*).  The JAX spelling the tasks pass
(``"params/llm"``) is accepted: a leading ``params/`` is dropped and the
rest matches whole path components of the state dict's names, as
``path_prefix_mask`` does.  Excluded tensors are never copied to the host.
"""

from __future__ import annotations

import logging
import os
import struct
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)


def state_prefixes(prefixes: Iterable[str]) -> Tuple[str, ...]:
    """JAX parameter paths ('params/llm', 'decoder/llm') -> state-dict
    prefixes ('llm', 'decoder.llm')."""
    out = []
    for p in prefixes:
        parts = [s for s in p.replace(".", "/").split("/") if s]
        if parts and parts[0] == "params":
            parts = parts[1:]
        if parts:
            out.append(".".join(parts))
    return tuple(out)


def _matches(name: str, prefixes: Sequence[str]) -> bool:
    return any(name == p or name.startswith(p + ".") for p in prefixes)


def host_state_dict(state_dict: Mapping[str, torch.Tensor],
                    exclude_prefixes: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    """The tensors not excluded, detached and copied to the CPU."""
    prefs = state_prefixes(exclude_prefixes)
    return {k: v.detach().cpu() for k, v in state_dict.items() if not _matches(k, prefs)}


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save(path: os.PathLike, obj: Dict) -> int:
    """torch.save through a temporary file, then rename; returns the bytes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(obj, tmp)
    tmp.replace(path)
    return path.stat().st_size


# ---------------------------------------------------------------------------
# flax msgpack (flax.serialization.msgpack_restore's format)
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _MsgpackReader:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = memoryview(data), 0, where

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.where}: truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return str(self.take(self.unpack(sizes[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(1 << (b - 0xD4))))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.unpack(sizes[b - 0xC7])
            code = self.unpack("b")
            return self.ext(code, bytes(self.take(n)))
        raise ValueError(f"{self.where}: msgpack type byte 0x{b:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, payload: bytes):
        if code == _EXT_COMPLEX:
            re_, im = _MsgpackReader(payload, self.where).value()
            return complex(re_, im)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"{self.where}: msgpack ext type {code} is not a flax type")
        shape, dtype, buf = _MsgpackReader(payload, self.where).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            arr = torch.from_numpy(np.frombuffer(buf, np.uint16).reshape(shape).copy())
            arr = arr.view(torch.bfloat16)
            return arr if code == _EXT_NDARRAY else arr.reshape(())
        arr = np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def _unchunk(tree):
    """flax's chunked form of an array above 2**30 bytes -> the array."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack(path: os.PathLike) -> Any:
    """A flax ``.msgpack`` file -> its tree: dicts, numpy arrays (bfloat16
    leaves as torch.bfloat16 tensors: numpy has no bfloat16), Python
    scalars and strings, as flax.serialization.msgpack_restore gives it."""
    data = Path(path).read_bytes()
    reader = _MsgpackReader(data, str(path))
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} bytes after the msgpack value")
    return _unchunk(tree)


def load(path: os.PathLike) -> Dict:
    """A state dict from a ``.pth`` file, or from a JAX package ``.msgpack``
    file (mapped to the port's names by convert.params_from_msgpack)."""
    if Path(path).suffix == ".msgpack":
        from llm_guided_asr_tpu_torch.convert import params_from_msgpack

        return params_from_msgpack(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def merge_loaded(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> List[str]:
    """Non-strict restore: copy the tensors present in ``state_dict`` into
    ``model`` (shapes must match; keys the model lacks are ignored), as the
    reference's strict=False resume skips the missing LLM (trainer.py:231-243).
    Returns the model's keys that were not in ``state_dict``."""
    return model.load_state_dict(dict(state_dict), strict=False).missing_keys


def load_partial(model: nn.Module, path: os.PathLike, src_prefix: str = "",
                 dst_prefix: str = "") -> List[str]:
    """init_param surgery, 'path:src_prefix:dst_prefix'
    (torch_utils/load_pretrained_model.py): the tensors of ``path`` (a
    ``{n}epoch.pth`` or the model part of a ``checkpoint.pth``) under
    ``src_prefix`` are loaded into ``model`` under ``dst_prefix``.  Both
    prefixes take the JAX spelling too.  Returns the model's keys not loaded."""
    loaded = load(path)
    if "model" in loaded and isinstance(loaded["model"], dict):
        loaded = loaded["model"]
    (src,) = state_prefixes([src_prefix]) or ("",)
    (dst,) = state_prefixes([dst_prefix]) or ("",)
    if dst and not any(_matches(k, (dst,)) for k in model.state_dict()):
        raise KeyError(f"init_param dst prefix {dst_prefix!r}: not in the model")
    picked = {}
    for k, v in loaded.items():
        if src and not _matches(k, (src,)):
            continue
        rest = k[len(src):].lstrip(".") if src else k
        picked[f"{dst}.{rest}" if dst and rest else (dst or rest)] = v
    return merge_loaded(model, picked)


class CheckpointManager:
    """Exp-dir checkpoint lifecycle (save / best links / n-best prune / average)."""

    def __init__(
        self,
        output_dir: os.PathLike,
        keep_nbest: int = 10,
        best_criteria: Sequence[Tuple[str, str, str]] = (("valid", "loss", "min"),),
        exclude_prefixes: Sequence[str] = (),
    ):
        self.dir = Path(output_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_nbest = keep_nbest
        self.best_criteria = [tuple(c) for c in best_criteria]
        self.exclude_prefixes = tuple(exclude_prefixes)

    def epoch_path(self, epoch: int) -> Path:
        return self.dir / f"{epoch}epoch.pth"

    def save_epoch(self, epoch: int, model: nn.Module, optimizer: torch.optim.Optimizer,
                   step: int, plateau_scale: float, reporter) -> List[Tuple[str, float, int]]:
        """Save the epoch's weights, the rolling full checkpoint and the
        reporter; returns (file name, seconds, bytes) of each save."""
        out = []
        t0 = time.perf_counter()
        weights = host_state_dict(model.state_dict(), self.exclude_prefixes)
        n = save(self.epoch_path(epoch), weights)
        out.append((self.epoch_path(epoch).name, time.perf_counter() - t0, n))
        t0 = time.perf_counter()
        full = {"model": weights, "optimizer": _to_host(optimizer.state_dict()),
                "step": int(step), "plateau_scale": float(plateau_scale)}
        n = save(self.dir / "checkpoint.pth", full)
        out.append(("checkpoint.pth", time.perf_counter() - t0, n))
        reporter.dump(self.dir / "reporter.json")
        self._update_best_links(reporter)
        self._prune(reporter)
        return out

    def _link(self, name: str, epoch: int):
        link = self.dir / name
        if link.is_symlink() or link.exists():
            link.unlink()
        link.symlink_to(self.epoch_path(epoch).name)

    def _update_best_links(self, reporter):
        self._link("latest.pth", reporter.epoch)
        for phase, key, mode in self.best_criteria:
            best = reporter.get_best_epoch(phase, key, mode)
            if best is not None and self.epoch_path(best).exists():
                self._link(f"{phase}.{key}.best.pth", best)

    def _keep_set(self, reporter) -> set:
        keep = {reporter.epoch}
        for phase, key, mode in self.best_criteria:
            keep.update(reporter.sort_epochs(phase, key, mode)[: self.keep_nbest])
        return keep

    def _prune(self, reporter):
        keep = self._keep_set(reporter)
        for p in self.dir.glob("*epoch.pth"):
            try:
                ep = int(p.name[: -len("epoch.pth")])
            except ValueError:
                continue
            if ep not in keep:
                p.unlink()
                logger.info(f"pruned checkpoint {p.name}")

    def average_nbest(self, reporter, phase: str, key: str, mode: str,
                      n: Optional[int] = None) -> Path:
        """Average the best-n epochs -> {phase}.{key}.ave_{n}best.pth.
        Floating tensors are summed in float64, best epoch first, and stored
        in their own dtype; integer buffers (the guided model's
        ctc_map_ids/ctc_map_lens, which have no JAX leaf) are not averaged
        but carried from the newest of the averaged epochs."""
        n = n or self.keep_nbest
        epochs = [e for e in reporter.sort_epochs(phase, key, mode)[:n]
                  if self.epoch_path(e).exists()]
        if not epochs:
            raise RuntimeError("no epochs to average")
        acc: Dict[str, torch.Tensor] = {}
        ave: Dict[str, torch.Tensor] = {}
        newest = max(epochs)
        for e in epochs:
            for k, v in load(self.epoch_path(e)).items():
                if v.is_floating_point():
                    acc[k] = acc[k] + v.double() if k in acc else v.double()
                    ave[k] = v  # the dtype to store
                elif e == newest:
                    ave[k] = v
        ave.update({k: (a / len(epochs)).to(ave[k].dtype) for k, a in acc.items()})
        out = self.dir / f"{phase}.{key}.ave_{len(epochs)}best.pth"
        save(out, ave)
        logger.info(f"averaged epochs {epochs} -> {out.name}")
        return out

    def has_checkpoint(self) -> bool:
        return (self.dir / "checkpoint.pth").exists()

    def load_checkpoint(self) -> Dict:
        return load(self.dir / "checkpoint.pth")
