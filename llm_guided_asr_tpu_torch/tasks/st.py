"""ST task: LLM-guided speech translation (counterpart of llm_guided_asr_tpu/tasks/st.py).

Wires LLMGuidedSTModel (models/llm_guided_st.py) into the trainer with
(speech, text = the translation, src_text = the source transcript)
batches, as the JAX ``STTask`` does:

- the source vocabulary is the LLM's unless ``src_token_list`` names
  another (:96-98); both text fields are tokenized by the config's
  tokenizer (the ``CommonPreprocessor`` of tasks/asr.py, which takes
  ``src_text`` too);
- the LLM is always frozen (:182-184) and left out of every checkpoint
  (``exclude_prefixes``, :205);
- ``build_model_from_file`` reads the port's ``.pth`` and the JAX
  package's ``.msgpack``, as ``ASRTask`` does.

``device: null`` (what the JAX package writes) means the card; only
``device: cpu`` runs on the CPU.  ``collect_stats`` is not read here, as
in the JAX package: the ASR task's ``--collect_stats`` writes the
``feats_stats.npz`` that ``normalize_conf.stats_file`` names.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from llm_guided_asr_tpu_torch.models.llm_guided import (
    guided_fields,
    llm_dtype,
    load_llm_params,
    resolve_llm_spec,
)
from llm_guided_asr_tpu_torch.models.llm_guided_st import LLMGuidedSTConfig, LLMGuidedSTModel
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.tasks.asr import (
    build_dataset,
    build_iter_factory,
    load_model_file,
    load_mvn_stats,
    resolve_task_device,
    trainer_options,
    translate_param_path,
)
from llm_guided_asr_tpu_torch.train.optim import build_optimizer, path_prefix_mask
from llm_guided_asr_tpu_torch.train.trainer import Trainer
from llm_guided_asr_tpu_torch.utils.config import (
    build_config,
    dump_yaml,
    filter_known_fields,
    load_yaml,
    read_token_list,
)
from llm_guided_asr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

ST_DEFAULTS: Dict[str, Any] = {
    "token_type": "hugging_face",
    "src_token_type": None,  # defaults to token_type
    "token_list": None,
    "src_token_list": None,
    "bpemodel": None,
    "model": "llm_guided_st",
    "model_conf": {},
    "llm": "llama",
    "llm_conf": {},
    "frontend": "default",
    "frontend_conf": {},
    "specaug": None,
    "specaug_conf": {},
    "normalize": "global_mvn",
    "normalize_conf": {},
    "encoder": "conformer",
    "encoder_conf": {},
    "decoder": "llm_guided_transformer_decoder",
    "decoder_conf": {},
    "extra_asr_decoder_conf": None,
    "optim": "adam",
    "optim_conf": {"lr": 0.001},
    "scheduler": "warmuplr",
    "scheduler_conf": {"warmup_steps": 25000},
    "grad_clip": 5.0,
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
    "batch_type": "numel",
    "batch_size": 20,
    "batch_bins": 1000000,
    "fold_length": 80000,
    "num_iters_per_epoch": None,
    "sort_in_batch": "descending",
    "train_data_path_and_name_and_type": [],
    "valid_data_path_and_name_and_type": [],
    "speech_pad_multiple": 1600,
    "text_pad_multiple": 8,
    "output_dir": "exp/st",
    "collect_stats": False,
    "dry_run": False,
    "device": None,
}
ST_BATCH_ARGS = ("speech", "speech_lengths", "text", "text_lengths", "src_text",
                 "src_text_lengths")


def build_st_model(config: Dict[str, Any], device: Union[str, torch.device, None] = None,
                   dtype: torch.dtype = torch.float32) -> LLMGuidedSTModel:
    """The ST model of a config (tasks/st.py build_st_model), on ``device``
    (default: the config's), computing in ``dtype`` (JAX's, passed from
    code: the ST trainer and CLIs build float32, as JAX's do); the LLM's
    weights are loaded by :func:`init_st_variables`."""
    dev = resolve_device(device) if device is not None else resolve_task_device(config)
    llm_conf = dict(config.get("llm_conf") or {})
    spec = resolve_llm_spec(llm_conf)
    model_conf = dict(config.get("model_conf") or {})
    src_vocab = spec["llm_config"].vocab_size
    if config.get("src_token_list"):
        src_vocab = len(read_token_list(config["src_token_list"]))
    extra = None
    if config.get("extra_asr_decoder_conf"):
        extra = TransformerDecoderConfig(**filter_known_fields(
            TransformerDecoderConfig, dict(config["extra_asr_decoder_conf"]),
            "extra_asr_decoder_conf"))
    cfg = LLMGuidedSTConfig(
        vocab_size=spec["llm_config"].vocab_size,
        src_vocab_size=src_vocab,
        llm=spec["llm_config"],
        prompt=spec["template"],
        extra_asr_decoder=extra,
        asr_weight=float(model_conf.get("asr_weight", 0.3)),
        mtlalpha=float(model_conf.get("mtlalpha", 0.5)),
        lsm_weight=float(model_conf.get("lsm_weight", 0.0)),
        length_normalized_loss=bool(model_conf.get("length_normalized_loss", False)),
        **guided_fields(config),
    )
    return LLMGuidedSTModel(cfg, llm_dtype=llm_dtype(llm_conf), device=dev, dtype=dtype)


@torch.no_grad()
def init_st_variables(model: LLMGuidedSTModel, config: Dict[str, Any], seed: int = 0
                      ) -> LLMGuidedSTModel:
    """Seeded weights (convert.init_weights), the MVN stats of
    ``normalize_conf.stats_file`` and the frozen LLM's weights (unless
    ``_skip_llm_weights``)."""
    from llm_guided_asr_tpu_torch.convert import init_weights

    init_weights(model, seed)
    stats_file = (config.get("normalize_conf") or {}).get("stats_file")
    if model.cfg.normalize == "global_mvn" and stats_file:
        stats = load_mvn_stats(stats_file)
        model.mvn_mean.copy_(stats["mean"])
        model.mvn_inv_std.copy_(stats["inv_std"])
    if not config.get("_skip_llm_weights"):
        load_llm_params(config, model=model)
    return model


class STTask:
    defaults = ST_DEFAULTS

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        return copy.deepcopy(cls.defaults)

    @classmethod
    def main(cls, cmd: Sequence[str]):
        """Train from ``--config`` and overrides; returns the trainer's
        final TrainState (None for dry_run)."""
        config = build_config(cmd, cls.get_default_config())
        device = resolve_task_device(config)
        output_dir = Path(config["output_dir"])
        output_dir.mkdir(parents=True, exist_ok=True)
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
        if config.get("collect_stats"):
            logger.warning("collect_stats is not read by the ST task (nor by the JAX one); "
                           "asr_train --collect_stats writes feats_stats.npz")
        # build (and thus validate) BEFORE dumping the config artifact
        model = build_st_model(config, device)
        options = dataclasses.replace(trainer_options(config, exclude=("params/llm",)),
                                      batch_args=ST_BATCH_ARGS)
        dump_yaml(config, output_dir / "config.yaml")
        if config.get("dry_run"):
            return None
        init_st_variables(model, config, int(config.get("seed", 0)))

        freeze = [translate_param_path(f) for f in (config.get("freeze_param") or [])]
        if "llm" not in freeze:
            freeze.append("llm")
        tx = build_optimizer(
            config.get("optim", "adam"), config.get("optim_conf"), config.get("scheduler"),
            config.get("scheduler_conf"), grad_clip=config.get("grad_clip", 5.0),
            freeze_mask=path_prefix_mask(model, freeze))
        train_ds = build_dataset(config, config["train_data_path_and_name_and_type"])
        valid_ds = build_dataset(config, config["valid_data_path_and_name_and_type"])
        train_iter = build_iter_factory(config, train_ds, shuffle=True, device=device)
        valid_iter = build_iter_factory(config, valid_ds, shuffle=False, device=device)
        return Trainer.run(model, tx, train_iter, valid_iter, output_dir, options)

    @classmethod
    def build_model_from_file(cls, config_file: Union[str, Path],
                              model_file: Optional[Union[str, Path]] = None,
                              device: Union[str, torch.device, None] = "cuda",
                              dtype: torch.dtype = torch.float32
                              ) -> Tuple[LLMGuidedSTModel, Dict[str, Any]]:
        """Rebuild (model, config) from a config.yaml of either package and
        a ``.pth`` or ``.msgpack`` checkpoint; the model is in eval mode on
        ``device``, computing in ``dtype`` (float32 by default, as JAX's)."""
        config = {**cls.get_default_config(), **load_yaml(config_file)}
        model = build_st_model(config, device, dtype)
        init_st_variables(model, config, int(config.get("seed", 0)))
        if model_file is not None:
            load_model_file(model, model_file)
        return model.eval(), config
