"""BERT-family body as the acoustic post-encoder (counterpart of
llm_guided_asr_tpu/models/hf_encoder.py).

``postencoder: hugging_face_transformers`` (or ``hugging_face``):
stride-2 length-adaptor convs with ReLU, ``linear_in`` to the pretrained
model's width, an optional language-token embedding prepended, then the
pretrained layer stack (HF ``model.encoder``) over those hidden states.
:class:`BertLayer` is BertLayer's post-LN computation (attention -> add &
LN -> exact-erf GELU FFN -> add & LN); bert, roberta and xlm-roberta
checkpoints load (:func:`convert_hf_bert_weights` from a state dict read by
models/hf_checkpoint.py), any other ``model_type`` raises, as in JAX.

The reference's quirks are kept, as the JAX module keeps them: the mask
is the additive extended one (keys past the length at -1e30), no
embeddings run over the hidden states, ``lang_token_id`` != -1 prepends
the token's word embedding (its raw row, not the embeddings' output) and
adds 1 to the lengths, and the adaptor raises on input shorter than its
ratio.  :class:`BertEmbeddings` (with RoBERTa's positions starting at
``pad_token_id + 1``) is here for the token-id encoder; the postencoder
does not run it.

Module names follow the flax modules (``body.layers_0.query``,
``attn_ln``, ``adaptor_0``, ``lang_token_embed``), so
convert.params_from_jax maps the JAX tree onto them.  Attention is plain
einsum with a float32 softmax: no hand-written kernel runs here.  The
post-encoder computes in its input's type (the model's compute dtype): in
bfloat16 the scores are scaled in it and normalized in float32, then cast
back (JAX models/hf_encoder.py:101-105).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.hf_checkpoint import load_hf_state_dict, read_hf_config
from llm_guided_asr_tpu_torch.models.transformer import Dense, LayerNorm, conv_in_dtype
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout

BERT_TYPES = ("bert", "roberta", "xlm-roberta")


@dataclasses.dataclass(frozen=True)
class BertBodyConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    pad_token_id: int = 0
    model_type: str = "bert"  # bert | roberta | xlm-roberta
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1

    @classmethod
    def from_hf_config(cls, hf: Mapping[str, Any]) -> "BertBodyConfig":
        """From a parsed ``config.json``; other model types raise."""
        if hf.get("model_type") not in BERT_TYPES:
            raise ValueError(f"hugging_face encoder/postencoder supports bert/roberta "
                             f"families; got model_type={hf.get('model_type')!r}")
        d = cls()
        return cls(
            hidden_size=hf.get("hidden_size", d.hidden_size),
            num_hidden_layers=hf.get("num_hidden_layers", d.num_hidden_layers),
            num_attention_heads=hf.get("num_attention_heads", d.num_attention_heads),
            intermediate_size=hf.get("intermediate_size", d.intermediate_size),
            layer_norm_eps=hf.get("layer_norm_eps", d.layer_norm_eps),
            vocab_size=hf.get("vocab_size", d.vocab_size),
            max_position_embeddings=hf.get("max_position_embeddings",
                                           d.max_position_embeddings),
            type_vocab_size=hf.get("type_vocab_size", 2),
            pad_token_id=hf.get("pad_token_id", 0) or 0,
            model_type=hf["model_type"],
            hidden_dropout=hf.get("hidden_dropout_prob", 0.1),
            attention_dropout=hf.get("attention_probs_dropout_prob", 0.1),
        )


class BertLayer(nn.Module):
    """One post-LN layer: self-attention (keys past the length at -1e30)
    -> add & LN -> GELU FFN -> add & LN, with the body's dropouts in
    training mode."""

    def __init__(self, cfg: BertBodyConfig):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.query = Dense(h, h)
        self.key = Dense(h, h)
        self.value = Dense(h, h)
        self.attn_out = Dense(h, h)
        self.attn_ln = LayerNorm(h, eps=eps)
        self.ff1 = Dense(h, cfg.intermediate_size)
        self.ff2 = Dense(cfg.intermediate_size, h)
        self.ff_ln = LayerNorm(h, eps=eps)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, rng: Optional[StepRNG] = None):
        cfg = self.cfg
        b, t, h = x.shape
        nh = cfg.num_attention_heads
        dk = h // nh
        q, k, v = (layer(x).reshape(b, t, nh, dk) for layer in (self.query, self.key, self.value))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
        scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        attn = dropout(attn, active_rate(self, cfg.attention_dropout), rng)
        ctx = self.attn_out(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, h))
        ctx = dropout(ctx, active_rate(self, cfg.hidden_dropout), rng)
        x = self.attn_ln(x + ctx)
        ff = dropout(self.ff2(F.gelu(self.ff1(x))), active_rate(self, cfg.hidden_dropout), rng)
        return self.ff_ln(x + ff)


class BertBody(nn.Module):
    """The layer stack alone (HF ``model.encoder``) over hidden states."""

    def __init__(self, cfg: BertBodyConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layers_{i}", BertLayer(cfg))

    def forward(self, x: torch.Tensor, valid: torch.Tensor, rng: Optional[StepRNG] = None):
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x, valid, rng)
        return x


class BertEmbeddings(nn.Module):
    """word + position + token-type (all 0) embeddings, LN and dropout;
    RoBERTa's positions start at ``pad_token_id + 1``."""

    def __init__(self, cfg: BertBodyConfig):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        cfg = self.cfg
        t = input_ids.shape[1]
        offset = cfg.pad_token_id + 1 if cfg.model_type != "bert" else 0
        pos = torch.arange(t, device=input_ids.device) + offset
        x = self.word(input_ids) + self.position(pos)[None] + self.token_type.weight[0]
        return dropout(self.ln(x), active_rate(self, cfg.hidden_dropout), rng)


@dataclasses.dataclass(frozen=True)
class HFPostEncoderConfig:
    body: BertBodyConfig
    length_adaptor_n_layers: int = 0
    lang_token_id: int = -1
    model_name_or_path: str = ""


class HFTransformersPostEncoder(nn.Module):
    """Length-adaptor convs -> ``linear_in`` -> [lang token] -> pretrained
    body: ([B, T, D] encoder output, lengths) -> ([B, T', H], lengths')."""

    def __init__(self, cfg: HFPostEncoderConfig, d_in: int):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.length_adaptor_n_layers):
            setattr(self, f"adaptor_{i}", nn.Conv1d(d_in, d_in, 2, stride=2))
        self.linear_in = Dense(d_in, cfg.body.hidden_size)
        if cfg.lang_token_id != -1:
            self.lang_token_embed = nn.Parameter(torch.zeros(cfg.body.hidden_size))
        self.body = BertBody(cfg.body)
        self.output_size = cfg.body.hidden_size

    def reset_jax_init(self):
        if hasattr(self, "lang_token_embed"):
            self.lang_token_embed.zero_()  # flax's zeros init

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        ratio = 2 ** cfg.length_adaptor_n_layers
        if x.shape[1] < ratio:
            raise ValueError(f"input has {x.shape[1]} frames; length adaptor needs >= {ratio}")
        if cfg.length_adaptor_n_layers:
            x = x.transpose(1, 2)
            for i in range(cfg.length_adaptor_n_layers):
                x = F.relu(conv_in_dtype(getattr(self, f"adaptor_{i}"), x))
            x = x.transpose(1, 2)
        lengths = torch.clamp(torch.div(lengths, ratio, rounding_mode="floor"), min=1)
        x = self.linear_in(x)
        if cfg.lang_token_id != -1:
            lang = self.lang_token_embed.to(x.dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([lang, x], dim=1)
            lengths = lengths + 1
        valid = make_valid_mask(lengths, x.shape[1])
        return self.body(x, valid, rng), lengths


def _float_state_dict(state_dict: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], str]:
    """The state dict in float32 on the CPU, and its ``bert.``/``roberta.``
    prefix (or none)."""
    sd = {k: (v.detach().float().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v))
          for k, v in state_dict.items()}
    for cand in ("bert.", "roberta.", ""):
        if any(k.startswith(cand + "encoder.layer.0.") for k in sd):
            return sd, cand
    return sd, ""


def _pick(sd: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    if name not in sd:
        raise KeyError(f"{name!r} not in the state dict")
    return sd[name].clone()


def _convert_bert_body(sd: Mapping[str, torch.Tensor], prefix: str, cfg: BertBodyConfig
                       ) -> Dict[str, torch.Tensor]:
    """The encoder layers' weights under the port's ``body.layers_{i}.*``."""
    names = {"query": "attention.self.query", "key": "attention.self.key",
             "value": "attention.self.value", "attn_out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm", "ff1": "intermediate.dense",
             "ff2": "output.dense", "ff_ln": "output.LayerNorm"}
    return {f"body.layers_{i}.{dst}.{leaf}": _pick(sd, f"{prefix}encoder.layer.{i}.{src}.{leaf}")
            for i in range(cfg.num_hidden_layers) for dst, src in names.items()
            for leaf in ("weight", "bias")}


def convert_hf_bert_weights(state_dict: Mapping[str, Any], cfg: BertBodyConfig
                            ) -> Dict[str, torch.Tensor]:
    """A BertModel/RobertaModel state dict (``bert.``/``roberta.`` prefix
    or none) -> the port's ``body.layers_{i}.*`` and ``embeddings.*``."""
    sd, prefix = _float_state_dict(state_dict)
    e = f"{prefix}embeddings."
    out = _convert_bert_body(sd, prefix, cfg)
    out.update({"embeddings.word.weight": _pick(sd, e + "word_embeddings.weight"),
                "embeddings.position.weight": _pick(sd, e + "position_embeddings.weight"),
                "embeddings.token_type.weight": _pick(sd, e + "token_type_embeddings.weight"),
                "embeddings.ln.weight": _pick(sd, e + "LayerNorm.weight"),
                "embeddings.ln.bias": _pick(sd, e + "LayerNorm.bias")})
    return out


def load_hf_postencoder_params(cfg: HFPostEncoderConfig) -> Dict[str, torch.Tensor]:
    """The pretrained part of :class:`HFTransformersPostEncoder`'s state
    dict from its local directory: ``body.*`` and, with a language token,
    ``lang_token_embed`` (the token's row of the word embeddings); the
    adaptor and ``linear_in`` keep their fresh weights, as in JAX."""
    sd, prefix = _float_state_dict(load_hf_state_dict(cfg.model_name_or_path))
    out = _convert_bert_body(sd, prefix, cfg.body)
    if cfg.lang_token_id != -1:
        words = _pick(sd, f"{prefix}embeddings.word_embeddings.weight")
        out["lang_token_embed"] = words[cfg.lang_token_id].clone()
    return out


def read_bert_config(name_or_path: Union[str, Path]) -> BertBodyConfig:
    return BertBodyConfig.from_hf_config(read_hf_config(name_or_path))
