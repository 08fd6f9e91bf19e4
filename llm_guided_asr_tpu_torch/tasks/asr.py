"""ASR task: config -> model/data/trainer wiring, collect-stats, main()
(counterpart of llm_guided_asr_tpu/tasks/asr.py).

Rebuild of espnet2/tasks/asr.py (ASRTask) and the machinery it inherits
from espnet2/tasks/abs_task.py (main, collect-stats,
build_model_from_file).  The resolved config dict is the single source of
truth; it is dumped to ``<output_dir>/config.yaml`` and is sufficient to
rebuild the model for inference.  The port reads the JAX package's
experiment directories too: their ``config.yaml`` (PyYAML's YAML 1.1,
read by utils/config.py) and their ``.msgpack`` checkpoints
(train/checkpoint.py).

Device: ``device: null`` (what the JAX package writes) means the card;
only ``device: cpu`` runs on the CPU.  A choice of the JAX package that the
port does not have yet raises NotImplementedError naming its ROADMAP item;
none is replaced by another in silence.
"""

from __future__ import annotations

import copy
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.data.dataset import (
    CommonCollateFn,
    CommonPreprocessor,
    ESPnetDataset,
)
from llm_guided_asr_tpu_torch.data.fileio import read_shape_file, write_shape_file
from llm_guided_asr_tpu_torch.data.iterator import SequenceIterFactory
from llm_guided_asr_tpu_torch.data.samplers import build_batch_sampler
from llm_guided_asr_tpu_torch.models.asr_model import (
    ASRModel,
    ASRModelConfig,
    raw_features,
)
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, encoder_conf_values
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig
from llm_guided_asr_tpu_torch.text.tokenizers import (
    HuggingFaceTokenIDConverter,
    HuggingFaceTokenizer,
    LLMTokenizer,
    TokenIDConverter,
    build_tokenizer,
)
from llm_guided_asr_tpu_torch.train import checkpoint
from llm_guided_asr_tpu_torch.train.optim import (
    PLATEAU_SCHEDULERS,
    build_optimizer,
    path_prefix_mask,
)
from llm_guided_asr_tpu_torch.train.trainer import Trainer, TrainerOptions
from llm_guided_asr_tpu_torch.utils.config import (
    build_config,
    dump_yaml,
    dumps_yaml,
    filter_known_fields,
    load_yaml,
    normalize_triples,
    read_token_list,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

ASR_DEFAULTS: Dict[str, Any] = {
    "token_type": "char",
    "token_list": None,
    "bpemodel": None,
    "input_size": None,  # None => raw audio via frontend
    "frontend": "default",  # default | none | ssl
    "frontend_conf": {},
    "specaug": None,  # specaug | None
    "specaug_conf": {},
    "preencoder": None,  # sinc | None
    "preencoder_conf": {},
    "postencoder": None,  # length_adaptor | hugging_face_transformers | None
    "postencoder_conf": {},
    "normalize": "global_mvn",  # global_mvn | utterance_mvn | none
    "normalize_conf": {},  # {stats_file: ...}
    "model": "espnet",  # espnet | llm_guided_asr | transducer
    "model_conf": {},
    "encoder": "conformer",
    "encoder_conf": {},
    "decoder": "transformer",
    "decoder_conf": {},
    "llm": None,
    "llm_conf": {},
    # training
    "optim": "adam",
    "optim_conf": {"lr": 0.001},
    "scheduler": "warmuplr",
    "scheduler_conf": {"warmup_steps": 25000},
    "grad_clip": 5.0,
    "grad_noise": False,
    "max_epoch": 40,
    "accum_grad": 1,
    "patience": None,
    "keep_nbest_models": 10,
    "best_model_criterion": [["valid", "loss", "min"]],
    "seed": 0,
    "log_interval": 100,
    "resume": False,
    "init_param": [],
    "freeze_param": [],
    # data
    "batch_type": "numel",
    "batch_size": 20,
    "batch_bins": 1000000,
    "fold_length": 80000,
    "num_iters_per_epoch": None,
    "sort_in_batch": "descending",
    "train_data_path_and_name_and_type": [],
    "valid_data_path_and_name_and_type": [],
    "train_shape_file": [],
    "valid_shape_file": [],
    "speech_pad_multiple": 1600,  # 0.1 s @ 16 kHz
    "text_pad_multiple": 8,
    "collect_stats": False,
    "output_dir": "exp/asr",
    "dry_run": False,
    "device": None,  # None = the card; 'cpu' runs on the CPU
    "train_dtype": None,  # float32 | bfloat16 (use_amp analog)
    "use_amp": False,
    "use_tensorboard": False,
    "use_wandb": False,
    "wandb_project": None,
    "wandb_name": None,
    "report_cer": False,
    # mixed-vocab CTC: its own token list and tokenizer for 'ctc_text'
    "ctc_conf": {},  # {ctc_type: builtin|builtin2|brctc, brctc_risk_factor}
    "ctc_token_list": None,
    "ctc_token_type": "char",
    "ctc_bpemodel": None,
    # parallelism (multi-card training is ROADMAP Queue 1 item 11)
    "data_parallel": None,
    "sharded_optim": False,
    "model_parallel": 1,
    "dist_coordinator": None,
    "dist_num_processes": None,
    "dist_process_id": None,
}

# the JAX package's choices the port does not have yet, by ROADMAP item
ITEM_MULTI_GPU = "ROADMAP Queue 1 item 11"
ITEM_ZOO = "ROADMAP Queue 1 item 12"

JAX_ENCODERS = ("conformer", "transformer", "e_branchformer", "branchformer",
                "contextual_block_conformer", "whisper_style", "longformer",
                "multiconvformer", "rnn", "vgg_rnn", "avhubert", "s4",
                "wav2vec2_hf", "hubert_hf", "whisper_hf")
JAX_DECODERS = ("transformer", "rnn", "s4", "lightconv", "dynamicconv", "hugging_face")
HF_ENCODERS = ("wav2vec2_hf", "hubert_hf", "whisper_hf")
HF_POSTENCODERS = ("hugging_face_transformers", "hugging_face")
JAX_MODELS = ("espnet", "llm_guided_asr", "maskctc", "transducer")

# fields the JAX config dataclasses carry and the JAX package never reads:
# accepted with any value and dropped (JAX builds the "latest" rel-pos
# encoding whatever rel_pos_type says, and ignores context_size)
_JAX_UNREAD_FIELDS = {
    "encoder_conf": ("rel_pos_type",),
    "transducer decoder_conf": ("context_size",),
}


def port_fields(cls, d: Optional[dict], where: str, jax_unread: str = "") -> dict:
    """``d`` filtered to the fields of the port's dataclass ``cls``: a field
    the JAX dataclass carries but never reads is dropped (``rel_pos_type:
    legacy`` with a warning that the latest encoding is built, as in JAX),
    and a field neither has is dropped with a warning (as the JAX package
    warns)."""
    d = dict(d or {})
    for k in _JAX_UNREAD_FIELDS.get(jax_unread or where, ()):
        value = d.pop(k, None)
        if k == "rel_pos_type" and value not in (None, "latest"):
            logger.warning(f"{where}.rel_pos_type={value!r}: the latest relative positional "
                           "encoding is built, as the JAX package builds it")
    return filter_known_fields(cls, d, where)


def resolve_task_device(config: Dict[str, Any]) -> torch.device:
    """``device`` of a config: null (the JAX package's default) is the card."""
    return resolve_device(config.get("device") or "cuda")


# ---------------------------------------------------------------------------
# model building
# ---------------------------------------------------------------------------

def _frontend_config(config: Dict[str, Any]) -> Optional[FrontendConfig]:
    """The log-mel (or fused, or sliding-window) frontend's config; None
    for ``frontend: none``/``ssl`` or with ``input_size``."""
    if config.get("frontend", "default") in (None, "none", "ssl") or (
            config.get("input_size") is not None):
        return None
    fe = port_fields(FrontendConfig, config.get("frontend_conf"), "frontend_conf")
    if fe.get("fmin") is None:
        fe["fmin"] = 0.0
    if fe.get("fused"):
        fe["fused"] = tuple(tuple(f) for f in fe["fused"])
    return FrontendConfig(**fe)


def _ssl_frontend_config(config: Dict[str, Any]):
    """``frontend: ssl``: the W2VConfig of ``frontend_conf``'s local
    wav2vec2/HuBERT directory (the s3prl frontend's analog)."""
    if config.get("frontend") != "ssl":
        return None
    from llm_guided_asr_tpu_torch.models.hf_checkpoint import read_hf_config
    from llm_guided_asr_tpu_torch.models.ssl_encoders import W2VConfig

    fc = dict(config.get("frontend_conf", {}) or {})
    name = fc.get("model_name_or_path")
    if not name:
        raise ValueError("frontend=ssl needs frontend_conf.model_name_or_path")
    kind = fc.get("kind", "wav2vec2")
    if kind not in ("wav2vec2", "hubert"):
        raise ValueError(f"frontend=ssl takes kind wav2vec2 or hubert; got {kind!r}")
    return W2VConfig.from_hf_config(read_hf_config(name))


def _preencoder_config(config: Dict[str, Any]):
    if not config.get("preencoder"):
        return None
    if config["preencoder"] != "sinc":
        raise ValueError(f"unknown preencoder {config['preencoder']!r}; known: sinc")
    from llm_guided_asr_tpu_torch.models.preencoder import SincPreencoderConfig

    return SincPreencoderConfig(**filter_known_fields(
        SincPreencoderConfig, config.get("preencoder_conf"), "preencoder_conf"))


def _postencoder_config(config: Dict[str, Any]):
    kind = config.get("postencoder")
    if not kind:
        return None
    pconf = dict(config.get("postencoder_conf", {}) or {})
    if kind == "length_adaptor":
        from llm_guided_asr_tpu_torch.models.preencoder import LengthAdaptorConfig

        return "length_adaptor", LengthAdaptorConfig.from_dict(pconf)
    if kind in HF_POSTENCODERS:
        from llm_guided_asr_tpu_torch.models.hf_encoder import (
            HFPostEncoderConfig,
            read_bert_config,
        )

        name = pconf.get("model_name_or_path")
        if not name:
            raise ValueError("postencoder hugging_face_transformers needs "
                             "postencoder_conf.model_name_or_path")
        return "hugging_face_transformers", HFPostEncoderConfig(
            body=read_bert_config(name),
            length_adaptor_n_layers=int(pconf.get("length_adaptor_n_layers", 0)),
            lang_token_id=int(pconf.get("lang_token_id", -1)), model_name_or_path=name)
    raise ValueError(f"unknown postencoder {kind!r}; known: length_adaptor, "
                     "hugging_face_transformers")


def _hf_decoder_config(config: Dict[str, Any]):
    """``decoder: hugging_face``: the local causal LM's config and the
    prompt's ids (the prefix with the tokenizer's special tokens, the
    postfix without, as ``AutoTokenizer.encode`` gives them in JAX; the
    directory's tokenizer is read only for a prompt)."""
    from llm_guided_asr_tpu_torch.models.hf_checkpoint import read_hf_config
    from llm_guided_asr_tpu_torch.models.hf_decoder import HFCausalDecoderConfig
    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig

    dec_conf = dict(config.get("decoder_conf", {}) or {})
    name = dec_conf.get("model_name_or_path")
    if not name:
        raise ValueError("decoder=hugging_face needs decoder_conf.model_name_or_path")
    prefix, postfix = dec_conf.get("prefix", ""), dec_conf.get("postfix", "")
    tok = LLMTokenizer.from_pretrained(name) if prefix or postfix else None
    return HFCausalDecoderConfig(
        llm=LlamaConfig.from_hf_config(read_hf_config(name)),
        prefix_ids=tuple(tok(prefix)["input_ids"]) if prefix else (),
        postfix_ids=tuple(tok(postfix, add_special_tokens=False)["input_ids"]) if postfix else (),
        enc_frames_max=int(dec_conf.get("enc_frames_max", 512)))


def _specaug_config(config: Dict[str, Any]) -> Optional[SpecAugConfig]:
    if config.get("specaug") != "specaug":
        return None
    sa = dict(config.get("specaug_conf", {}) or {})
    sa.pop("time_warp_mode", None)  # interpolation mode: always linear
    for k in ("freq_mask_width_range", "time_mask_width_range", "time_mask_width_ratio_range"):
        if sa.get(k) is not None:
            sa[k] = tuple(sa[k])
    return SpecAugConfig(**sa)


def _encoder_config(config: Dict[str, Any]) -> Tuple[str, ConformerConfig]:
    encoder_type = config.get("encoder", "conformer")
    if encoder_type not in JAX_ENCODERS:
        raise ValueError(f"unknown encoder {encoder_type!r}; known: {JAX_ENCODERS}")
    enc = port_fields(ConformerConfig, config.get("encoder_conf"), "encoder_conf")
    return encoder_type, ConformerConfig(**encoder_conf_values(enc))


def _vocab_size(config: Dict[str, Any]) -> int:
    if config.get("token_list") is None and config.get("token_type") == "hugging_face":
        # the token list is the LLM tokenizer's vocabulary
        return len(LLMTokenizer.from_pretrained(_hf_model_name(config)))
    return len(read_token_list(config["token_list"]))


def _check_unported_asr_choices(config: Dict[str, Any], model: str = "espnet"):
    """The choices only the CTC/attention model reads raise for the
    transducer and the guided models (the JAX package ignores them there)."""
    if model != "espnet":
        for key in ("preencoder", "postencoder"):
            if config.get(key):
                raise ValueError(f"{key}={config[key]!r} is read by model=espnet only")
        if config.get("frontend") == "ssl":
            raise ValueError("frontend=ssl is read by model=espnet only")
    ctc_type = (config.get("ctc_conf") or {}).get("ctc_type", "builtin")
    if ctc_type not in ("builtin", "builtin2", "brctc"):
        raise ValueError(f"unknown ctc_type {ctc_type!r}; known: builtin, builtin2, brctc")


def build_model_config(config: Dict[str, Any]) -> ASRModelConfig:
    """The CTC/attention model's config (``model: espnet``)."""
    _check_unported_asr_choices(config)
    encoder_type, encoder = _encoder_config(config)
    decoder_type = config.get("decoder", "transformer")
    if decoder_type not in JAX_DECODERS:
        raise ValueError(f"unknown decoder {decoder_type!r}; known: {JAX_DECODERS}")
    hf = decoder_type == "hugging_face"
    model_conf = dict(config.get("model_conf", {}) or {})
    frontend = _frontend_config(config)
    ssl_frontend = _ssl_frontend_config(config)
    return ASRModelConfig(
        vocab_size=_vocab_size(config),
        frontend=frontend,
        specaug=_specaug_config(config),
        normalize=config.get("normalize") or "none",
        encoder_type=encoder_type,
        encoder=encoder,
        decoder_type=decoder_type,
        decoder=TransformerDecoderConfig(**port_fields(
            TransformerDecoderConfig, {} if hf else config.get("decoder_conf"), "decoder_conf")),
        hf_decoder=_hf_decoder_config(config) if hf else None,
        ssl_frontend=ssl_frontend,
        preencoder=_preencoder_config(config),
        postencoder=_postencoder_config(config),
        input_size=(int(config.get("input_size") or 80)
                    if frontend is None and ssl_frontend is None else None),
        ctc_weight=float(model_conf.get("ctc_weight", 0.5)),
        ctc_type=(config.get("ctc_conf") or {}).get("ctc_type", "builtin"),
        brctc_risk_factor=float((config.get("ctc_conf") or {}).get("brctc_risk_factor", 0.0)),
        interctc_weight=float(model_conf.get("interctc_weight", 0.0)),
        lsm_weight=float(model_conf.get("lsm_weight", 0.0)),
        length_normalized_loss=bool(model_conf.get("length_normalized_loss", False)),
    )


def build_transducer_config(config: Dict[str, Any]):
    """The transducer's config (``model: transducer``): every prediction
    network (stateless, rnn, rwkv, mega) and the multi-blank loss
    (``model_conf.transducer_multi_blank_durations``, ``multi_blank_ids``,
    ``transducer_multi_blank_sigma``)."""
    from llm_guided_asr_tpu_torch.models.transducer import (
        TransducerDecoderConfig,
        TransducerModelConfig,
    )

    _check_unported_asr_choices(config, "transducer")
    encoder_type, encoder = _encoder_config(config)
    model_conf = dict(config.get("model_conf", {}) or {})
    dec = port_fields(TransducerDecoderConfig, config.get("decoder_conf"), "decoder_conf",
                      "transducer decoder_conf")
    frontend = _frontend_config(config)
    return TransducerModelConfig(
        vocab_size=_vocab_size(config),
        frontend=frontend,
        specaug=_specaug_config(config),
        normalize=config.get("normalize") or "none",
        encoder_type=encoder_type,
        encoder=encoder,
        decoder=TransducerDecoderConfig(**dec),
        joint_size=int(model_conf.get("joint_size", 256)),
        aux_ctc_weight=float(model_conf.get("aux_ctc_weight", 0.0)),
        multi_blank_durations=tuple(model_conf.get("transducer_multi_blank_durations") or ()),
        multi_blank_ids=tuple(model_conf.get("multi_blank_ids") or ()),
        multi_blank_sigma=float(model_conf.get("transducer_multi_blank_sigma", 0.05)),
        input_size=None if frontend is not None else int(config.get("input_size") or 80),
    )


def resolve_dtype(config: Dict[str, Any], dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """``dtype`` if given, else ``train_dtype`` (``use_amp`` the analog):
    float32, or bfloat16 for ``bfloat16``/``bf16`` (JAX tasks/asr.py:304)."""
    if dtype is not None:
        return dtype
    name = config.get("train_dtype") or ("bfloat16" if config.get("use_amp") else "float32")
    if name not in _DTYPES:
        raise ValueError(f"unknown train_dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def build_model(config: Dict[str, Any], device: Union[str, torch.device, None] = None,
                dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The model of a config, on ``device`` (default: the config's),
    computing in ``dtype`` (default: the config's ``train_dtype``):
    float32, or bfloat16 for every model and choice the port builds."""
    dtype = resolve_dtype(config, dtype)
    dev = resolve_device(device) if device is not None else resolve_task_device(config)
    name = config.get("model", "espnet")
    if name == "llm_guided_asr":
        from llm_guided_asr_tpu_torch.models.llm_guided import build_llm_guided_model

        _check_unported_asr_choices(config, name)
        _encoder_config(config)
        return build_llm_guided_model(config, device=dev, dtype=dtype)
    if name == "transducer":
        from llm_guided_asr_tpu_torch.models.transducer import TransducerModel

        return TransducerModel(build_transducer_config(config), device=dev, dtype=dtype)
    if name == "espnet":
        return ASRModel(build_model_config(config), device=dev, dtype=dtype)
    if name in JAX_MODELS:
        raise NotImplementedError(f"model={name!r} is not ported yet ({ITEM_ZOO})")
    raise ValueError(f"unknown model {name!r}; known: {JAX_MODELS}")


def load_mvn_stats(stats_file: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """feats_stats.npz {count, sum, sum_square} -> {mean, inv_std} (global_mvn.py:26)."""
    npz = np.load(stats_file)
    count = float(npz["count"])
    mean = npz["sum"] / count
    var = np.maximum(npz["sum_square"] / count - mean**2, 0.0)
    std = np.maximum(np.sqrt(var), 1.0e-20)
    return {"mean": torch.from_numpy(np.asarray(mean, np.float32)),
            "inv_std": torch.from_numpy(np.asarray(1.0 / std, np.float32))}


def _load_into(module: nn.Module, sd: Dict[str, torch.Tensor], where: str,
               partial: bool = False) -> None:
    """Copy a converted pretrained state dict into ``module`` (each tensor
    cast to its parameter's type); a tensor without a home raises, and so
    does a parameter the checkpoint leaves out unless ``partial``."""
    own = module.state_dict()
    unknown = sorted(set(sd) - set(own))
    missing = [] if partial else sorted(set(own) - set(sd))
    if unknown or missing:
        raise KeyError(f"{where}: tensors without a home {unknown[:8]}, "
                       f"missing {missing[:8]}")
    for k, v in sd.items():
        if own[k].shape != v.shape:
            raise ValueError(f"{where}.{k}: checkpoint shape {tuple(v.shape)} != "
                             f"{tuple(own[k].shape)}")
        own[k].copy_(v.to(own[k].dtype))


@torch.no_grad()
def init_model_variables(model: nn.Module, config: Dict[str, Any], seed: int = 0) -> nn.Module:
    """Seeded weights (convert.init_weights: the port's init is not
    flax's), then the MVN stats of ``normalize_conf.stats_file``, the
    frozen LLM's weights (unless ``_skip_llm_weights``), the mixed-vocab
    CTC map (built with the model) and the pretrained Hugging Face weights
    of local directories (JAX tasks/asr.py:417-456): the ``hugging_face``
    decoder's LM and the BERT post-encoder's body (unless
    ``_skip_llm_weights``), the SSL frontend's and the ``*_hf`` encoders'
    trunks (unless ``_skip_pretrained_encoder``).  The port builds every
    module at its size, so no dummy batch runs (JAX's flax init takes one:
    a raw waveform for these choices)."""
    from llm_guided_asr_tpu_torch.convert import init_weights

    init_weights(model, seed)
    stats_file = (config.get("normalize_conf") or {}).get("stats_file")
    if model.cfg.normalize == "global_mvn" and stats_file:
        stats = load_mvn_stats(stats_file)
        model.mvn_mean.copy_(stats["mean"])
        model.mvn_inv_std.copy_(stats["inv_std"])
    if config.get("model") == "llm_guided_asr" and not config.get("_skip_llm_weights"):
        from llm_guided_asr_tpu_torch.models.llm_guided import load_llm_params

        load_llm_params(config, model=model)
    skip_llm, skip_enc = config.get("_skip_llm_weights"), config.get("_skip_pretrained_encoder")
    if config.get("decoder") == "hugging_face" and not skip_llm:
        from llm_guided_asr_tpu_torch.models.llm.llama import stream_checkpoint

        name = (config.get("decoder_conf") or {})["model_name_or_path"]
        sd = stream_checkpoint(name, model.cfg.hf_decoder.llm)
        _load_into(model.decoder.llm, sd, "decoder.llm")
        logger.info(f"loaded pretrained decoder LM weights from {name}")
    if config.get("frontend") == "ssl" and not skip_enc:
        from llm_guided_asr_tpu_torch.models.ssl_encoders import load_pretrained_encoder

        fc = dict(config.get("frontend_conf", {}) or {})
        _, sd = load_pretrained_encoder(fc["model_name_or_path"], fc.get("kind", "wav2vec2"))
        _load_into(model.ssl_frontend, sd, "ssl_frontend")
        logger.info(f"loaded frozen SSL frontend weights from {fc['model_name_or_path']}")
    enc_type = config.get("encoder")
    if enc_type in HF_ENCODERS and not skip_enc:
        from llm_guided_asr_tpu_torch.models.ssl_encoders import load_pretrained_encoder

        name = (config.get("encoder_conf") or {}).get("model_name_or_path")
        _, sd = load_pretrained_encoder(name, enc_type[: -len("_hf")])
        _load_into(model.encoder.ssl, sd, "encoder.ssl")
        logger.info(f"loaded pretrained {enc_type} encoder weights from {name}")
    if config.get("postencoder") in HF_POSTENCODERS and not skip_llm:
        from llm_guided_asr_tpu_torch.models.hf_encoder import load_hf_postencoder_params

        _, post_cfg = model.cfg.postencoder
        _load_into(model.postencoder, load_hf_postencoder_params(post_cfg), "postencoder",
                   partial=True)
        logger.info(f"loaded pretrained postencoder body from {post_cfg.model_name_or_path}")
    return model


# reference freeze_param / init_param names (dot paths) -> module paths; the
# port names its modules as the flax modules are named
_PARAM_NAME_ALIASES = {
    "encoder": "encoder",
    "ctc": "ctc_head",
    "ctc.ctc_lo": "ctc_head",
    "decoder": "decoder",
    "decoder.llm": "llm",
    "decoder.llm.lm": "llm",
    "llm": "llm",
    "decoder.embed": "embed",
    "embed": "embed",
}


def translate_param_path(name: str) -> str:
    """A reference parameter path -> the port's module path ('.'-joined)."""
    if name in _PARAM_NAME_ALIASES:
        return _PARAM_NAME_ALIASES[name]
    return name.replace("/", ".")


def apply_init_param(model: nn.Module, init_param: Sequence[str]) -> nn.Module:
    """'path:src:dst' surgery entries (load_pretrained_model.py); ``path``
    is a ``.pth`` of the port or a ``.msgpack`` of the JAX package (one
    entry may come as a string)."""
    for spec in [init_param] if isinstance(init_param, str) else init_param:
        parts = spec.split(":")
        src = translate_param_path(parts[1]) if len(parts) > 1 and parts[1] else ""
        dst = translate_param_path(parts[2]) if len(parts) > 2 and parts[2] else ""
        checkpoint.load_partial(model, parts[0], src, dst)
        logger.info(f"loaded init_param {spec}")
    return model


# ---------------------------------------------------------------------------
# data building
# ---------------------------------------------------------------------------

def _hf_model_name(config: Dict[str, Any]) -> Optional[str]:
    return config.get("bpemodel") or (config.get("llm_conf") or {}).get("model_name_or_path")


def build_text_converter(config: Dict[str, Any]):
    """(tokenizer, id_converter) per token_type; hugging_face shares the
    LLM tokenizer, so text ids live in the LLM vocabulary."""
    token_type = config.get("token_type", "char")
    if token_type == "hugging_face":
        name = _hf_model_name(config)
        return HuggingFaceTokenizer(name), HuggingFaceTokenIDConverter(name)
    tokenizer = build_tokenizer(token_type, bpemodel=config.get("bpemodel"),
                                g2p=config.get("g2p"))
    return tokenizer, TokenIDConverter(read_token_list(config["token_list"]))


def build_preprocess_fn(config: Dict[str, Any]) -> CommonPreprocessor:
    tokenizer, converter = build_text_converter(config)
    field_tokenizers = None
    if config.get("ctc_token_list"):
        # mixed-vocab CTC: 'ctc_text' tokenizes in its own vocabulary
        ctc_tok = build_tokenizer(config.get("ctc_token_type", "char"),
                                  bpemodel=config.get("ctc_bpemodel"))
        ctc_conv = TokenIDConverter(read_token_list(config["ctc_token_list"]))
        field_tokenizers = {"ctc_text": (ctc_tok, ctc_conv)}
    cleaner = None
    if config.get("cleaner"):
        from llm_guided_asr_tpu_torch.text.cleaner import TextCleaner

        cleaner = TextCleaner(config["cleaner"])
    return CommonPreprocessor(tokenizer, converter, field_tokenizers=field_tokenizers,
                              cleaner=cleaner)


def build_dataset(config: Dict[str, Any], triples: Sequence) -> ESPnetDataset:
    has_text = config.get("token_list") or config.get("token_type") == "hugging_face"
    pre = build_preprocess_fn(config) if has_text else None
    return ESPnetDataset(normalize_triples(triples), preprocess=pre)


def _check_mesh(config: Dict[str, Any]):
    changed = [k for k in ("data_parallel", "dist_coordinator") if config.get(k) is not None]
    if int(config.get("model_parallel") or 1) != 1:
        changed.append("model_parallel")
    if config.get("sharded_optim"):
        changed.append("sharded_optim")
    if changed:
        raise NotImplementedError(f"{changed}: multi-card training is not ported yet "
                                  f"({ITEM_MULTI_GPU})")


def build_iter_factory(config: Dict[str, Any], dataset: ESPnetDataset, shuffle: bool,
                       shape_files: Sequence[str] = (),
                       device: Union[str, torch.device, None] = "cuda") -> SequenceIterFactory:
    _check_mesh(config)
    lengths = None
    if shape_files:
        lengths = {k: v[0] for k, v in read_shape_file(shape_files[0]).items()}
        lengths = {k: v for k, v in lengths.items() if k in set(dataset.keys)}
    elif config.get("batch_type", "numel") != "unsorted":
        # no shape files: peek lengths from headers
        lengths = {k: dataset.peek_length(k) for k in dataset.keys}
    batches = build_batch_sampler(
        config.get("batch_type", "numel"), dataset.keys, lengths=lengths,
        batch_size=int(config.get("batch_size", 20)),
        batch_bins=int(config.get("batch_bins", 1000000)),
        fold_length=int(config.get("fold_length", 80000)),
        sort_in_batch=config.get("sort_in_batch", "descending"),
    )
    tpad = int(config.get("text_pad_multiple", 8))
    collate = CommonCollateFn(pad_multiples={
        "speech": int(config.get("speech_pad_multiple", 1600)), "text": tpad,
        "durations": tpad, "pitch": tpad, "energy": tpad,
    })
    return SequenceIterFactory(dataset, batches, collate, shuffle=shuffle,
                               seed=int(config.get("seed", 0)),
                               num_iters_per_epoch=config.get("num_iters_per_epoch"),
                               device=device)


# ---------------------------------------------------------------------------
# collect stats (main_funcs/collect_stats.py:21)
# ---------------------------------------------------------------------------

@torch.no_grad()
def frontend_feats(model: nn.Module, speech: torch.Tensor, speech_lengths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frontend alone, in float32 (the JAX models' collect_feats): the
    log-mel (or, for the CTC/attention model, fused, sliding-window or
    frozen-SSL) features [B, T, F] and their lengths."""
    if isinstance(model, ASRModel):
        return model.raw_features(speech, speech_lengths)
    return raw_features(model, speech, speech_lengths)


class FeatsStats:
    """count, sum and sum of squares of the frontend's features, one
    utterance at a time (the frontend on the model's device, the sums in
    numpy float32 as the JAX package sums them)."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.device = next(model.parameters()).device
        self.count, self.sum, self.sum_square = 0, None, None

    def add(self, speech: np.ndarray):
        speech = np.asarray(speech, np.float32)
        feats, n = frontend_feats(self.model, torch.from_numpy(speech[None]).to(self.device),
                                  torch.tensor([len(speech)], device=self.device))
        feats = feats[0, : int(n[0])].cpu().numpy()
        self.count += feats.shape[0]
        s, sq = feats.sum(0), (feats**2).sum(0)
        self.sum = s if self.sum is None else self.sum + s
        self.sum_square = sq if self.sum_square is None else self.sum_square + sq

    def save(self, path: Union[str, Path]):
        np.savez(path, count=self.count, sum=self.sum, sum_square=self.sum_square)


def collect_stats(config: Dict[str, Any], output_dir: Path,
                  device: Union[str, torch.device, None] = None) -> Dict[str, float]:
    """feats_stats.npz (count, sum, sum_square of the frontend's features,
    summed in numpy float32 as the JAX package sums them) and the shape
    files of each split; returns each split's seconds."""
    config = {**config, "_skip_llm_weights": True}
    model = build_model(config, device).eval()
    # the frozen SSL trunk (and the fused frontend's projections) shape the features
    init_model_variables(model, config, int(config.get("seed", 0)))
    seconds = {}
    for split in ("train", "valid"):
        triples = config[f"{split}_data_path_and_name_and_type"]
        if not triples:
            continue
        t0 = time.perf_counter()
        dataset = build_dataset(config, triples)
        sdir = Path(output_dir) / split
        sdir.mkdir(parents=True, exist_ok=True)
        stats = FeatsStats(model)
        speech_shapes, text_shapes = {}, {}
        for uid in dataset.keys:
            item = dataset[uid]
            stats.add(item["speech"])
            speech_shapes[uid] = np.asarray(item["speech"]).shape
            if "text" in item:
                text_shapes[uid] = np.asarray(item["text"]).shape
        stats.save(sdir / "feats_stats.npz")
        write_shape_file(sdir / "speech_shape", speech_shapes)
        if text_shapes:
            write_shape_file(sdir / "text_shape", text_shapes)
        seconds[split] = time.perf_counter() - t0
        logger.info(f"collect_stats[{split}]: {len(speech_shapes)} utts, {stats.count} frames")
    return seconds


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _batch_args(config: Dict[str, Any]):
    """The model inputs of a batch: the four positional ones, plus the
    biasing words and the mixed-vocab CTC targets (keywords of the guided
    model) when the training data has them."""
    names = {t[1] for t in normalize_triples(config["train_data_path_and_name_and_type"])}
    extra = [k for k in ("bias_words", "ctc_text") if k in names]
    if not extra:
        return ("speech", "speech_lengths", "text", "text_lengths")
    keys = ["speech", "speech_lengths", "text", "text_lengths"]
    for k in extra:
        keys += [k, f"{k}_lengths"]
    return lambda batch: {k: batch[k] for k in keys}


def trainer_options(config: Dict[str, Any], exclude: Sequence[str] = ()) -> TrainerOptions:
    exclude = list(config.get("exclude_checkpoint_prefixes", ()) or ()) + list(exclude)
    if config.get("model") == "llm_guided_asr" and "params/llm" not in exclude:
        exclude.append("params/llm")  # never persist the frozen LLM (trainer.py:408-417)
    return TrainerOptions(
        max_epoch=int(config.get("max_epoch", 40)),
        accum_grad=int(config.get("accum_grad", 1)),
        log_interval=int(config.get("log_interval", 100)),
        patience=config.get("patience"),
        keep_nbest_models=int(config.get("keep_nbest_models", 10)),
        best_model_criterion=[tuple(c) for c in config.get("best_model_criterion")],
        resume=bool(config.get("resume", False)),
        seed=int(config.get("seed", 0)),
        exclude_prefixes=tuple(exclude),
        use_tensorboard=bool(config.get("use_tensorboard", False)),
        use_wandb=bool(config.get("use_wandb", False)),
        wandb_project=config.get("wandb_project"),
        wandb_name=config.get("wandb_name"),
        report_ctc_er=bool(config.get("report_cer", False)),
        data_parallel=config.get("data_parallel"),
        model_parallel=int(config.get("model_parallel", 1) or 1),
        sharded_optim=bool(config.get("sharded_optim", False)),
        flat_optim=bool(config.get("flat_optim", False)),
        val_scheduler_criterion=tuple(config.get("val_scheduler_criterion")
                                      or ("valid", "loss")),
        plateau_conf=(dict(config.get("scheduler_conf") or {})
                      if str(config.get("scheduler") or "").lower() in PLATEAU_SCHEDULERS
                      else None),
        batch_args=_batch_args(config),
    )


class ASRTask:
    defaults = ASR_DEFAULTS

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        return copy.deepcopy(cls.defaults)

    @classmethod
    def main(cls, cmd: Sequence[str]):
        """Train (or collect stats) from ``--config`` and overrides; returns
        the trainer's final TrainState (None for print_config, dry_run and
        collect_stats)."""
        config = build_config(cmd, cls.get_default_config())
        if config.get("print_config"):
            sys.stdout.write(dumps_yaml({k: v for k, v in config.items()
                                         if k != "print_config"}))
            return None
        known = set(cls.defaults) | {"exclude_checkpoint_prefixes", "print_config"}
        for k in config:
            if k not in known:
                logger.warning(f"unknown config key {k!r} (typo?); ignoring")
        _check_mesh(config)
        device = resolve_task_device(config)
        output_dir = Path(config["output_dir"])
        output_dir.mkdir(parents=True, exist_ok=True)
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(message)s")
        if config.get("collect_stats"):
            collect_stats(config, output_dir, device)
            return None

        # build (and thus validate) BEFORE dumping the config artifact, so a
        # bad invocation can never clobber a valid exp dir's config.yaml
        model = build_model(config, device)
        options = trainer_options(config)
        dump_yaml(config, output_dir / "config.yaml")
        if config.get("dry_run"):
            logger.info("dry_run: config written, exiting")
            return None
        init_model_variables(model, config, int(config.get("seed", 0)))
        if config.get("init_param"):
            apply_init_param(model, config["init_param"])

        freeze = [translate_param_path(f) for f in (config.get("freeze_param") or [])]
        if config.get("model") == "llm_guided_asr" and "llm" not in freeze:
            freeze.append("llm")  # the LLM is always frozen (llm_guided_asr_model.py)
        tx = build_optimizer(
            config.get("optim", "adam"), config.get("optim_conf"), config.get("scheduler"),
            config.get("scheduler_conf"), grad_clip=config.get("grad_clip", 5.0),
            freeze_mask=path_prefix_mask(model, freeze) if freeze else (),
            grad_noise=bool(config.get("grad_noise", False)),
        )
        train_ds = build_dataset(config, config["train_data_path_and_name_and_type"])
        valid_ds = build_dataset(config, config["valid_data_path_and_name_and_type"])
        train_iter = build_iter_factory(config, train_ds, shuffle=True, device=device,
                                        shape_files=config.get("train_shape_file", []))
        valid_iter = build_iter_factory(config, valid_ds, shuffle=False, device=device,
                                        shape_files=config.get("valid_shape_file", []))
        return Trainer.run(model, tx, train_iter, valid_iter, output_dir, options)

    @classmethod
    def build_model_from_file(cls, config_file: Union[str, Path],
                              model_file: Optional[Union[str, Path]] = None,
                              device: Union[str, torch.device, None] = "cuda",
                              dtype: torch.dtype = torch.float32
                              ) -> Tuple[nn.Module, Dict[str, Any]]:
        """Rebuild (model, config) from a config.yaml artifact of either
        package and a ``.pth`` or ``.msgpack`` checkpoint (abs_task.py:2272);
        the model is in eval mode on ``device`` (the config's device is the
        training run's and is not read here), computing in ``dtype``:
        float32 by default, as JAX's, whatever ``train_dtype`` the training
        run had."""
        config = {**cls.get_default_config(), **load_yaml(config_file)}
        model = build_model(config, device, dtype)
        init_model_variables(model, config, int(config.get("seed", 0)))
        if model_file is not None:
            load_model_file(model, model_file)
        return model.eval(), config


def load_model_file(model: nn.Module, model_file: Union[str, Path]) -> List[str]:
    """Load a ``.pth`` (the weights or a full ``checkpoint.pth``) or a JAX
    ``.msgpack`` into ``model``; a tensor the model has no home for raises,
    naming it.  Returns the model's keys the file did not hold (the frozen
    LLM)."""
    sd = checkpoint.load(model_file)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    own = model.state_dict()
    unknown = sorted(k for k in sd if k not in own)
    if unknown:
        raise KeyError(f"{model_file}: {len(unknown)} tensor(s) have no counterpart in the "
                       f"model: {unknown[:8]}")
    return checkpoint.merge_loaded(model, {k: v.to(own[k].dtype) for k, v in sd.items()})
