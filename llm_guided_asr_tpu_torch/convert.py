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
``hz`` without) -> ``rnn_0.if``, and the transducer's LSTM cells, which
flax names ``decoder/OptimizedLSTMCell_{i}/ii`` .. ``ho`` ->
``decoder.OptimizedLSTMCell_0.ii``); only the leaf names and layouts
differ (RWKV's [C] leaves ``mu_*``, ``time_decay`` and ``time_first``, and
MEGA's EMA matrices ``damping_factor`` .. ``kernel_projection_matrix``
[D, N], ``residual_weight``, ``qk_weight``, ``qk_bias``,
``relative_position_bias`` and the rotary ``alpha``/``beta``, the S4
layers' ``log_dt``, ``log_a_re``, ``a_im``, ``log_neg_re``, ``lam_im``,
``d`` and their complex ``c``, ``p``, ``b`` stored as a trailing (real,
imag) pair, the lightconv decoder's ``conv_weight`` and the affine
residual's ``affine`` keep their names and layouts; the (VGG-)RNN
encoder's LSTM cells are flax's auto-named ``OptimizedLSTMCell_{j}``, the
RNN decoder's ``cell/lstm_{i}``, the multichannel frontend's mask
estimator ``mc_frontend/OptimizedLSTMCell_0`` (forward) and ``_1``
(reverse) beside ``mc_frontend/mask_out``; AV-HuBERT keeps flax's names,
``encoder/trunk/video_resnet/s{i}b{j}/conv1`` and the rest):

  Dense kernel [in, out]          -> Linear weight [out, in]
  Conv kernel HWIO [kh, kw, i, o] -> Conv2d weight OIHW
  Conv kernel [kt, kh, kw, i, o]  -> Conv3d weight [o, i, kt, kh, kw]
                                     (AV-HuBERT's video stem)
  depthwise kernel [K, 1, C]      -> DepthwiseConv1d weight [K, C] (also a
                                     conv of one input channel: the RNN
                                     decoder's ``att_conv``)
  1-D conv kernel [K, i, o]       -> Conv1d weight [o, i, K] (Whisper's stems;
                                     the SSL trunks' ``conv_layers_*`` and
                                     ``pos_conv_embed_conv`` also at i = 1)
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


def _full_conv(mods) -> bool:
    """A 1-D conv whose kernel stays [o, i, K] whatever its input width:
    the SSL trunks' feature-extractor convs (one input channel at layer 0)
    and grouped positional conv, and AV-HuBERT's grouped positional conv."""
    return bool(mods) and (mods[-1].startswith("conv_layers_") or mods[-1] == "pos_conv_embed_conv"
                           or mods[-2:] == ["pos_conv", "conv"])


def _param(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        elif arr.ndim == 3 and arr.shape[1] == 1 and not _full_conv(mods):
            arr = arr[:, 0, :]
        elif arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
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
    means, the rel-pos biases and the Branchformer's ``branch_weights``
    (zeros at flax's init) 0; norm scales (LayerNorm, RMSNorm, the
    masked batch norm, the SSL trunks' group norm) and running variances
    1; every other weight (dense, conv, depthwise conv, the decoders'
    token embeddings, the LSTM gates, RWKV's, MEGA's and the S4 layers'
    named leaves, the lightconv weights) N(0, 0.02).  A module with a ``reset_jax_init`` method then takes flax's own init
    from it (the sinc filters' mel band edges, the sinc pre-encoder's batch
    norms, the post-encoder's zero language-token embedding).
    """
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    norms = (nn.LayerNorm, nn.GroupNorm, RMSNorm, MaskedBatchNorm)
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name in ("bias", "branch_weights") or name.startswith("pos_bias"):
                p.zero_()
            elif isinstance(module, norms):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
        if isinstance(module, MaskedBatchNorm):
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
        if hasattr(module, "reset_jax_init"):
            module.reset_jax_init()
    return model
