"""Weight bridge between the JAX package's variables and the port's modules.

The port names its modules after the flax modules, so a flax path maps to
a torch name by joining it with dots (``encoder/block_0/conv_module/norm``
-> ``encoder.block_0.conv_module.norm``, ``decoder/embed`` ->
``decoder.embed``, ``decoder/block_0/att/key`` -> ``decoder.block_0.att.key``,
for the LLM-guided model, the CTC/attention ASRModel and the transducer
alike, and for the language models of models/lm.py: ``lm/block_0/norm1``
-> ``lm.block_0.norm1`` under ESPnetLanguageModel, and a recurrent LM's
per-gate Dense modules ``rnn_0/if`` (LSTM: ``ii``..``io`` without bias,
``hi``..``ho`` with it; GRU: ``ir`` ``iz`` ``in`` ``hn`` with it, ``hr``
``hz`` without) -> ``rnn_0.if``); only the leaf names and layouts differ
(RWKV's [C] leaves ``mu_*``, ``time_decay`` and ``time_first`` keep their
names):

  Dense kernel [in, out]          -> Linear weight [out, in]
  Conv kernel HWIO [kh, kw, i, o] -> Conv2d weight OIHW
  depthwise kernel [K, 1, C]      -> DepthwiseConv1d weight [K, C]
  LayerNorm/BatchNorm scale       -> weight;  Embed embedding -> weight
  batch_stats mean / var          -> running_mean / running_var
  mvn mean / inv_std              -> mvn_mean / mvn_inv_std
  ctc_map ids / lens              -> ctc_map_ids / ctc_map_lens (int64)

:func:`init_weights` instead draws weights from a seed on the model's own
device, for runs that have no checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import MaskedBatchNorm
from llm_guided_asr_tpu_torch.models.llm.llama import RMSNorm

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_MVN_NAMES = {"mean": "mvn_mean", "inv_std": "mvn_inv_std"}


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _param(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3 and arr.shape[1] == 1:
            arr = arr[:, 0, :]
        else:
            raise ValueError(f"unexpected kernel shape {arr.shape} at {'/'.join(path)}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(mods + [leaf]), arr


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (``params``, ``batch_stats``, ``mvn``, ``ctc_map``;
    numpy leaves) -> a state dict for the port's module of the same structure."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables.get("params", {})):
        name, arr = _param(path, np.asarray(leaf))
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        name = ".".join(path[:-1] + (_STAT_NAMES[path[-1]],))
        sd[name] = torch.from_numpy(np.asarray(leaf, dtype=np.float32).copy())
    for path, leaf in _walk(variables.get("mvn", {})):
        sd[_MVN_NAMES[path[-1]]] = torch.from_numpy(np.asarray(leaf, dtype=np.float32).copy())
    for path, leaf in _walk(variables.get("ctc_map", {})):
        sd[f"ctc_map_{path[-1]}"] = torch.from_numpy(np.asarray(leaf, dtype=np.int64).copy())
    return sd


def params_from_msgpack(path) -> Dict[str, torch.Tensor]:
    """A JAX package ``.msgpack`` file of model variables (``{n}epoch``,
    ``ave_{n}best``) -> :func:`params_from_jax` of its tree; bfloat16
    leaves widen to float32 exactly, as numpy does them in params_from_jax.
    A collection the port has no home for raises, naming it."""
    from llm_guided_asr_tpu_torch.train.checkpoint import read_msgpack

    tree = read_msgpack(path)
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path}: not a tree of model variables")
    unknown = sorted(set(tree) - {"params", "batch_stats", "mvn", "ctc_map"})
    if unknown:
        raise KeyError(f"{path}: variable collection(s) {unknown} have no counterpart in "
                       f"the port (known: params, batch_stats, mvn, ctc_map)")

    def widen(t):
        if isinstance(t, Mapping):
            return {k: widen(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            return t.float().numpy()
        return t

    return params_from_jax(widen(tree))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every weight from ``seed`` on the model's device.

    The rule of the JAX benchmark's host_init_variables: biases, running
    means and the rel-pos biases 0; norm scales (LayerNorm, RMSNorm, the
    masked batch norm) and running variances 1; every other weight (dense,
    conv, depthwise conv, the decoders' token embeddings) N(0, 0.02).
    """
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    norms = (nn.LayerNorm, RMSNorm, MaskedBatchNorm)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name == "bias" or name.startswith("pos_bias"):
                p.zero_()
            elif isinstance(module, norms):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        if isinstance(module, MaskedBatchNorm):
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
    return model
