"""Reference (ESPnet) torch state dicts -> parameter trees (counterpart of
llm_guided_asr_tpu/models/espnet_ingest.py).

The port keeps its own numpy copy of the JAX package's name map: each
function returns the tree in the JAX package's layout (Dense kernels [in,
out], Conv kernels HWIO, depthwise kernels [K, 1, C], norm ``scale``), and
:func:`llm_guided_asr_tpu_torch.convert.params_from_jax` turns that tree
into the port's state dict, so one layout rule serves both.

Layout rules:
- torch Linear weight [out, in]        -> Dense kernel [in, out]
- torch Conv2d weight [out, in, kh, kw]-> Conv kernel [kh, kw, in, out]
- torch Conv1d weight [out, in/g, k]   -> Conv kernel [k, in/g, out]
- torch LayerNorm/BatchNorm weight,bias-> scale,bias (running stats ->
  batch_stats collection)
- Conv2dSubsampling output Linear: the reference flattens [B,C,T,F] as
  (c * F + f) (subsampling.py: transpose(1,2).view(b,t,c*f)); the JAX
  package and the port flatten (F', C) as (f * C + c) -- rows are permuted
  accordingly.

:func:`params_from_reference` is the front door for a whole model's state
dict whose keys carry the reference's ``enc.``, ``dec.`` and ``ctc.``
prefixes (the golden fixtures' ``sd_*`` arrays, tests/parity/);
:func:`transformer_lm_params` reads a reference TransformerLM's state dict
(``golden_trained_lm.npz``'s ``lm_*`` arrays); :func:`transducer_params`
the LSTM prediction network and joint network of ``golden_transducer.npz``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def _lin(sd, name):
    out = {"kernel": np.ascontiguousarray(sd[f"{name}.weight"].T)}
    if f"{name}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{name}.bias"])
    return out


def _ln(sd, name):
    return {"scale": np.asarray(sd[f"{name}.weight"]), "bias": np.asarray(sd[f"{name}.bias"])}


def _mha(sd, name, rel_pos: bool = False):
    out = {
        "linear_q": _lin(sd, f"{name}.linear_q"),
        "linear_k": _lin(sd, f"{name}.linear_k"),
        "linear_v": _lin(sd, f"{name}.linear_v"),
        "linear_out": _lin(sd, f"{name}.linear_out"),
    }
    if rel_pos:
        out["linear_pos"] = _lin(sd, f"{name}.linear_pos")
        out["pos_bias_u"] = np.asarray(sd[f"{name}.pos_bias_u"])
        out["pos_bias_v"] = np.asarray(sd[f"{name}.pos_bias_v"])
    return out


def _ffn(sd, name):
    return {"w_1": _lin(sd, f"{name}.w_1"), "w_2": _lin(sd, f"{name}.w_2")}


def _conv2d(sd, name):
    w = np.asarray(sd[f"{name}.weight"])  # [out, in, kh, kw]
    return {
        "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
        "bias": np.asarray(sd[f"{name}.bias"]),
    }


def _subsample_out_linear(sd, name, n_freq_out: int, odim: int):
    """embed.out.0 Linear with (c*F+f) -> (f*C+c) row permutation."""
    w = np.asarray(sd[f"{name}.weight"]).T  # [C*F, odim] rows indexed c*F+f
    c, f = odim, n_freq_out
    perm = np.empty(c * f, np.int64)
    for fi in range(f):
        for ci in range(c):
            perm[fi * c + ci] = ci * f + fi
    return {"kernel": np.ascontiguousarray(w[perm]), "bias": np.asarray(sd[f"{name}.bias"])}


def conformer_encoder_params(
    sd: Dict[str, np.ndarray],
    num_blocks: int,
    input_size: int,
    odim: int,
    macaron: bool = True,
    use_cnn: bool = True,
    prefix: str = "",
) -> Tuple[Dict, Dict]:
    """Reference ConformerEncoder state_dict -> (params, batch_stats)."""
    p = prefix
    n_freq_out = (((input_size - 1) // 2) - 1) // 2
    params: Dict = {
        "embed": {
            "conv_0": _conv2d(sd, f"{p}embed.conv.0"),
            "conv_1": _conv2d(sd, f"{p}embed.conv.2"),
            "out": _subsample_out_linear(sd, f"{p}embed.out.0", n_freq_out, odim),
        },
        "after_norm": _ln(sd, f"{p}after_norm"),
    }
    batch_stats: Dict = {}
    for i in range(num_blocks):
        r = f"{p}encoders.{i}"
        blk = {
            "self_attn": _mha(sd, f"{r}.self_attn", rel_pos=True),
            "feed_forward": _ffn(sd, f"{r}.feed_forward"),
            "norm_mha": _ln(sd, f"{r}.norm_mha"),
            "norm_ff": _ln(sd, f"{r}.norm_ff"),
        }
        if macaron:
            blk["feed_forward_macaron"] = _ffn(sd, f"{r}.feed_forward_macaron")
            blk["norm_ff_macaron"] = _ln(sd, f"{r}.norm_ff_macaron")
        if use_cnn:
            pw1 = np.asarray(sd[f"{r}.conv_module.pointwise_conv1.weight"])[..., 0]
            pw2 = np.asarray(sd[f"{r}.conv_module.pointwise_conv2.weight"])[..., 0]
            dw = np.asarray(sd[f"{r}.conv_module.depthwise_conv.weight"])  # [d,1,k]
            blk["conv_module"] = {
                "pointwise_conv1": {
                    "kernel": np.ascontiguousarray(pw1.T),
                    "bias": np.asarray(sd[f"{r}.conv_module.pointwise_conv1.bias"]),
                },
                "depthwise_conv": {
                    "kernel": np.ascontiguousarray(dw.transpose(2, 1, 0)),
                    "bias": np.asarray(sd[f"{r}.conv_module.depthwise_conv.bias"]),
                },
                "pointwise_conv2": {
                    "kernel": np.ascontiguousarray(pw2.T),
                    "bias": np.asarray(sd[f"{r}.conv_module.pointwise_conv2.bias"]),
                },
                "norm": {
                    "scale": np.asarray(sd[f"{r}.conv_module.norm.weight"]),
                    "bias": np.asarray(sd[f"{r}.conv_module.norm.bias"]),
                },
            }
            blk["norm_conv"] = _ln(sd, f"{r}.norm_conv")
            blk["norm_final"] = _ln(sd, f"{r}.norm_final")
            batch_stats[f"block_{i}"] = {
                "conv_module": {
                    "norm": {
                        "mean": np.asarray(sd[f"{r}.conv_module.norm.running_mean"]),
                        "var": np.asarray(sd[f"{r}.conv_module.norm.running_var"]),
                    }
                }
            }
        params[f"block_{i}"] = blk
    return params, batch_stats


def transformer_decoder_params(
    sd: Dict[str, np.ndarray], num_blocks: int, prefix: str = ""
) -> Dict:
    """Reference TransformerDecoder state_dict -> params."""
    p = prefix
    params: Dict = {
        "embed": {"embedding": np.asarray(sd[f"{p}embed.0.weight"])},
        "after_norm": _ln(sd, f"{p}after_norm"),
    }
    if f"{p}output_layer.weight" in sd:
        params["output_layer"] = _lin(sd, f"{p}output_layer")
    for i in range(num_blocks):
        r = f"{p}decoders.{i}"
        params[f"block_{i}"] = {
            "self_attn": _mha(sd, f"{r}.self_attn"),
            "src_attn": _mha(sd, f"{r}.src_attn"),
            "feed_forward": _ffn(sd, f"{r}.feed_forward"),
            "norm1": _ln(sd, f"{r}.norm1"),
            "norm2": _ln(sd, f"{r}.norm2"),
            "norm3": _ln(sd, f"{r}.norm3"),
        }
    return params


def transformer_lm_params(sd: Dict[str, np.ndarray], num_blocks: int) -> Dict:
    """Reference TransformerLM state dict (the ``lm_*`` arrays) -> params of
    models/lm.py TransformerLM.

    Torch layout (espnet2/lm/transformer_lm.py): embed (Embedding) -> the
    encoder with input_layer='linear' (encoder.embed.0 Linear, encoder.embed.1
    LayerNorm, then ReLU and the positional encoding) -> encoder.encoders.N
    pre-norm blocks -> encoder.after_norm -> the decoder Linear head.
    """
    params: Dict = {
        "embed": {"embedding": np.asarray(sd["embed.weight"])},
        "input_proj": _lin(sd, "encoder.embed.0"),
        "input_norm": _ln(sd, "encoder.embed.1"),
        "after_norm": _ln(sd, "encoder.after_norm"),
        "output": _lin(sd, "decoder"),
    }
    for i in range(num_blocks):
        r = f"encoder.encoders.{i}"
        params[f"block_{i}"] = {
            "self_attn": _mha(sd, f"{r}.self_attn"),
            "feed_forward": _ffn(sd, f"{r}.feed_forward"),
            "norm1": _ln(sd, f"{r}.norm1"),
            "norm2": _ln(sd, f"{r}.norm2"),
        }
    return params


def ctc_head_params(sd: Dict[str, np.ndarray], prefix: str = "ctc_lo") -> Dict:
    return _lin(sd, prefix)


def transducer_params(dec_sd: Dict[str, np.ndarray], joint_sd: Dict[str, np.ndarray],
                      num_layers: int = 1) -> Dict:
    """The reference's TransducerDecoder (LSTM) and JointNetwork -> the
    transducer's ``decoder`` and ``joint`` params.

    torch's LSTM packs the gates [i; f; g; o] into weight_ih/hh [4H, *]
    with two biases; flax's OptimizedLSTMCell keeps per-gate Denses (``ii``
    .. ``io`` input kernels without bias, ``hi`` .. ``ho`` hidden kernels
    with bias = bias_ih + bias_hh), under the name flax gives the cell,
    ``OptimizedLSTMCell_{layer}``."""
    params: Dict = {
        "decoder": {"embed": {"embedding": np.asarray(dec_sd["embed.weight"])}},
        "joint": {name: _lin(joint_sd, name) for name in ("lin_enc", "lin_dec", "lin_out")},
    }
    for layer in range(num_layers):
        w_ih = np.asarray(dec_sd[f"decoder.{layer}.weight_ih_l0"])  # [4H, E]
        w_hh = np.asarray(dec_sd[f"decoder.{layer}.weight_hh_l0"])  # [4H, H]
        bias = (np.asarray(dec_sd[f"decoder.{layer}.bias_ih_l0"])
                + np.asarray(dec_sd[f"decoder.{layer}.bias_hh_l0"]))
        hdim = w_hh.shape[1]
        cell: Dict = {}
        for gi, gate in enumerate(("i", "f", "g", "o")):
            rows = slice(gi * hdim, (gi + 1) * hdim)
            cell[f"i{gate}"] = {"kernel": np.ascontiguousarray(w_ih[rows].T)}
            cell[f"h{gate}"] = {"kernel": np.ascontiguousarray(w_hh[rows].T),
                                "bias": np.asarray(bias[rows])}
        params["decoder"][f"OptimizedLSTMCell_{layer}"] = cell
    return params


def llm_guided_decoder_params(
    sd: Dict[str, np.ndarray], num_blocks: int, prefix: str = ""
) -> Dict:
    """Reference LLMGuidedTransformerDecoder state_dict -> top-level params.

    The guided decoder's `embed` is the Linear(llm_hidden -> enc_dim)
    installed by LLMGuidedASRModel (llm_guided_asr_model.py:119-125), not an
    Embedding; blocks/after_norm/output_layer follow the standard decoder
    layout (transformer_decoder.py:946-1012).  Returns a flat dict matching
    models/llm_guided.py setup names (embed, block_i, after_norm,
    output_layer) for merging into the model's params root.
    """
    p = prefix
    params: Dict = {
        "embed": _lin(sd, f"{p}embed"),
        "after_norm": _ln(sd, f"{p}after_norm"),
        "output_layer": _lin(sd, f"{p}output_layer"),
    }
    for i in range(num_blocks):
        r = f"{p}decoders.{i}"
        params[f"block_{i}"] = {
            "self_attn": _mha(sd, f"{r}.self_attn"),
            "src_attn": _mha(sd, f"{r}.src_attn"),
            "feed_forward": _ffn(sd, f"{r}.feed_forward"),
            "norm1": _ln(sd, f"{r}.norm1"),
            "norm2": _ln(sd, f"{r}.norm2"),
            "norm3": _ln(sd, f"{r}.norm3"),
        }
    return params


def params_from_reference(sd: Mapping[str, np.ndarray], meta: Mapping) -> Dict:
    """A CTC/attention or LLM-guided model's reference state dict (keys
    ``enc.*``, ``dec.*``, ``ctc.*``) -> variables ``{"params", "batch_stats"}``
    in the JAX package's layout, for ``convert.params_from_jax``.

    ``meta`` gives the sizes: ``blocks``, ``dec_blocks``, ``input_size`` and
    ``odim`` (the encoder is the macaron Conformer with the conv module).
    A decoder whose ``embed`` is a Linear (``dec.embed.weight``) is the
    LLM-guided one, whose layers sit at the model's top level; an
    ``Embedding`` (``dec.embed.0.weight``) is the transformer decoder
    under ``decoder``.  The LLM's weights are not in ``sd``.
    """
    parts = {p: {k[len(p) + 1:]: np.asarray(v) for k, v in sd.items() if k.startswith(p + ".")}
             for p in ("enc", "dec", "ctc")}
    enc_params, enc_bs = conformer_encoder_params(
        parts["enc"], num_blocks=meta["blocks"], input_size=meta["input_size"],
        odim=meta["odim"], macaron=True, use_cnn=True,
    )
    params: Dict = {"encoder": enc_params, "ctc_head": ctc_head_params(parts["ctc"], "ctc_lo")}
    if "embed.weight" in parts["dec"]:
        params.update(llm_guided_decoder_params(parts["dec"], meta["dec_blocks"]))
    else:
        params["decoder"] = transformer_decoder_params(parts["dec"], meta["dec_blocks"])
    return {"params": params, "batch_stats": {"encoder": enc_bs}}
