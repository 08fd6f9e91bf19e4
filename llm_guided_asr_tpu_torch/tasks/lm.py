"""LM task: train a Transformer/RNN LM for shallow fusion, and perplexity
(counterpart of llm_guided_asr_tpu/tasks/lm.py).

Rebuild of espnet2/tasks/lm.py (LMTask) on the ASR task's machinery.
:func:`build_lm` builds the ESPnet LM from a config dict: ``token_list``
(a file or a list) sets the vocabulary, ``lm`` picks ``transformer`` or
``seq_rnn`` and ``lm_conf`` holds its fields.  ``LMTask.main`` trains it
from a YAML config; ``LMTask.build_model_from_file`` rebuilds it from an
experiment directory of either package (``.pth`` or ``.msgpack``);
:func:`calc_perplexity` is lm_calc_perplexity's corpus perplexity.
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from llm_guided_asr_tpu_torch.models.lm import (
    ESPnetLanguageModel,
    SequentialRNNLM,
    SequentialRNNLMConfig,
    TransformerLM,
    TransformerLMConfig,
)
from llm_guided_asr_tpu_torch.utils.config import (
    build_config,
    dump_yaml,
    load_yaml,
    read_token_list,
)

logger = logging.getLogger(__name__)

LM_DEFAULTS: Dict[str, Any] = {
    "token_type": "char",
    "token_list": None,
    "bpemodel": None,
    "lm": "transformer",  # transformer | seq_rnn
    "lm_conf": {},
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
    "batch_type": "sorted",
    "batch_size": 64,
    "batch_bins": 1000000,
    "num_iters_per_epoch": None,
    "sort_in_batch": "descending",
    "train_data_path_and_name_and_type": [],
    "valid_data_path_and_name_and_type": [],
    "text_pad_multiple": 8,
    "output_dir": "exp/lm",
    "collect_stats": False,
    "dry_run": False,
    "device": None,
}


def build_lm(config: Dict[str, Any],
             device: Union[str, torch.device] = "cuda") -> ESPnetLanguageModel:
    vocab_size = len(read_token_list(config["token_list"]))
    lm_type = config.get("lm", "transformer")
    conf = dict(config.get("lm_conf", {}) or {})
    if lm_type == "transformer":
        lm = TransformerLM(TransformerLMConfig.from_dict(conf, vocab_size), device=device)
    elif lm_type in ("seq_rnn", "sequential_rnn"):
        lm = SequentialRNNLM(SequentialRNNLMConfig.from_dict(conf, vocab_size), device=device)
    else:
        raise ValueError(f"unknown lm type {lm_type!r}")
    return ESPnetLanguageModel(lm, vocab_size)


class LMTask:
    defaults = LM_DEFAULTS

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        return copy.deepcopy(cls.defaults)

    @classmethod
    def main(cls, cmd: Sequence[str]):
        """Train from ``--config`` and overrides; returns the final
        TrainState (None for dry_run)."""
        from llm_guided_asr_tpu_torch.convert import init_weights
        from llm_guided_asr_tpu_torch.tasks.asr import (
            build_dataset,
            build_iter_factory,
            resolve_task_device,
        )
        from llm_guided_asr_tpu_torch.train.optim import build_optimizer
        from llm_guided_asr_tpu_torch.train.trainer import Trainer, TrainerOptions

        config = build_config(cmd, cls.get_default_config())
        device = resolve_task_device(config)
        output_dir = Path(config["output_dir"])
        output_dir.mkdir(parents=True, exist_ok=True)
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(message)s")
        model = build_lm(config, device)
        dump_yaml(config, output_dir / "config.yaml")
        if config.get("dry_run"):
            return None
        init_weights(model, int(config.get("seed", 0)))
        tx = build_optimizer(config.get("optim", "adam"), config.get("optim_conf"),
                             config.get("scheduler"), config.get("scheduler_conf"),
                             grad_clip=config.get("grad_clip", 5.0))
        # LM data has no speech: pad only text
        config = {**config, "speech_pad_multiple": 1}
        train_ds = build_dataset(config, config["train_data_path_and_name_and_type"])
        valid_ds = build_dataset(config, config["valid_data_path_and_name_and_type"])
        train_iter = build_iter_factory(config, train_ds, shuffle=True, device=device)
        valid_iter = build_iter_factory(config, valid_ds, shuffle=False, device=device)
        options = TrainerOptions(
            max_epoch=int(config.get("max_epoch", 40)),
            accum_grad=int(config.get("accum_grad", 1)),
            log_interval=int(config.get("log_interval", 100)),
            patience=config.get("patience"),
            keep_nbest_models=int(config.get("keep_nbest_models", 10)),
            best_model_criterion=[tuple(c) for c in config.get("best_model_criterion")],
            resume=bool(config.get("resume", False)),
            seed=int(config.get("seed", 0)),
            batch_args=("text", "text_lengths"),
        )
        return Trainer.run(model, tx, train_iter, valid_iter, output_dir, options)

    @classmethod
    def build_model_from_file(cls, config_file: Union[str, Path],
                              model_file: Optional[Union[str, Path]] = None,
                              device: Union[str, torch.device] = "cuda"
                              ) -> Tuple[ESPnetLanguageModel, Dict[str, Any]]:
        """(model in eval mode, config) from a config.yaml and a ``.pth`` or
        ``.msgpack`` checkpoint of either package."""
        from llm_guided_asr_tpu_torch.convert import init_weights
        from llm_guided_asr_tpu_torch.tasks.asr import load_model_file

        config = {**cls.get_default_config(), **load_yaml(config_file)}
        model = build_lm(config, device)
        init_weights(model, int(config.get("seed", 0)))
        if model_file is not None:
            load_model_file(model, model_file)
        return model.eval(), config


@torch.no_grad()
def calc_perplexity(config_file: Union[str, Path], model_file: Union[str, Path],
                    data_path_and_name_and_type: Sequence[Tuple[str, str, str]],
                    batch_size: int = 32, device: Union[str, torch.device] = "cuda") -> float:
    """Corpus perplexity (espnet2/bin/lm_calc_perplexity.py analog): the
    summed token NLL over the summed token count, in batches of
    ``batch_size`` utterances in the dataset's order."""
    from llm_guided_asr_tpu_torch.tasks.asr import build_dataset

    model, config = LMTask.build_model_from_file(config_file, model_file, device)
    dev = next(model.parameters()).device
    ds = build_dataset(config, data_path_and_name_and_type)
    total_nll, total_tok = 0.0, 0
    keys = list(ds.keys)
    for i in range(0, len(keys), batch_size):
        chunk = keys[i : i + batch_size]
        arrays = [np.asarray(ds[k]["text"]) for k in chunk]
        maxlen = max(a.shape[0] for a in arrays)
        text = np.full((len(chunk), maxlen), -1, np.int64)
        for j, a in enumerate(arrays):
            text[j, : a.shape[0]] = a
        lens = np.asarray([a.shape[0] for a in arrays], np.int64)
        nll, counts = model.nll(torch.from_numpy(text).to(dev), torch.from_numpy(lens).to(dev))
        total_nll += float(nll.sum())
        total_tok += int(counts.sum())
    return float(np.exp(total_nll / max(total_tok, 1)))
