"""High-level Python API: train without recipe scp files (counterpart of
llm_guided_asr_tpu/ez/__init__.py; espnetez analog).

Bring an in-memory dataset (uid -> {"speech": array or wav path, "text":
str}) and a config dict; the Trainer wires tokenization, batching and the
training runtime of the ASR, LM and ST tasks (ST items also carry
"src_text"):

    import llm_guided_asr_tpu_torch.ez as ez
    trainer = ez.Trainer(task="asr", config=cfg, train_dataset=d1,
                         valid_dataset=d2, output_dir="exp/run")
    trainer.collect_stats()   # optional, for global_mvn
    trainer.train()

``config["device"]`` picks the device (null: the card).  The JAX
package's generic-domain tasks raise (ROADMAP Queue 1 item 12).  The
``st`` task trains the ST model of tasks/st.py; the JAX ez.Trainer merges
the ST defaults but builds the ASR task's model.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)


class ESPnetEZDataset:
    """In-memory dataset adapter (espnetez/dataset.py analog)."""

    def __init__(self, data: Mapping[str, Dict[str, Any]], preprocess=None):
        self.data = dict(data)
        self.keys = sorted(self.data)
        self.preprocess = preprocess

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, uid: str) -> Dict[str, Any]:
        item = dict(self.data[uid])
        if isinstance(item.get("speech"), (str, Path)):
            from llm_guided_asr_tpu_torch.data.fileio import read_audio

            _, item["speech"] = read_audio(str(item["speech"]))
        if self.preprocess is not None:
            item = self.preprocess(uid, item)
        return item


class Trainer:
    """espnetez/trainer.py analog over the task machinery."""

    def __init__(self, task: str, config: Dict[str, Any],
                 train_dataset: Union[ESPnetEZDataset, Mapping],
                 valid_dataset: Union[ESPnetEZDataset, Mapping],
                 output_dir: Union[str, Path]):
        if task not in ("asr", "lm", "st"):
            raise NotImplementedError(f"task {task!r} is not ported yet (the JAX package's "
                                      f"generic tasks: ROADMAP Queue 1 item 12)")
        from llm_guided_asr_tpu_torch.tasks.asr import ASRTask, build_preprocess_fn
        from llm_guided_asr_tpu_torch.tasks.lm import LMTask
        from llm_guided_asr_tpu_torch.tasks.st import STTask

        self.task = task
        self.output_dir = Path(output_dir)
        base = {"lm": LMTask, "st": STTask}.get(task, ASRTask)
        self.config = {**base.get_default_config(), **config,
                       "output_dir": str(self.output_dir)}
        has_text = self.config.get("token_list") or self.config.get("token_type") == "hugging_face"
        pre = build_preprocess_fn(self.config) if has_text else None
        self.train_dataset = self._wrap(train_dataset, pre)
        self.valid_dataset = self._wrap(valid_dataset, pre)

    @staticmethod
    def _wrap(ds, pre) -> ESPnetEZDataset:
        if isinstance(ds, ESPnetEZDataset):
            ds.preprocess = pre
            return ds
        return ESPnetEZDataset(ds, pre)

    @property
    def device(self) -> torch.device:
        from llm_guided_asr_tpu_torch.tasks.asr import resolve_task_device

        return resolve_task_device(self.config)

    def _iter_factory(self, dataset: ESPnetEZDataset, shuffle: bool):
        from llm_guided_asr_tpu_torch.data.dataset import CommonCollateFn
        from llm_guided_asr_tpu_torch.data.iterator import SequenceIterFactory
        from llm_guided_asr_tpu_torch.data.samplers import build_batch_sampler

        cfg = self.config
        lengths = {}
        for k in dataset.keys:
            item = dataset[k]
            lengths[k] = int(np.asarray(item.get("speech", item.get("text"))).shape[0])
        batches = build_batch_sampler(cfg.get("batch_type", "sorted"), dataset.keys,
                                      lengths=lengths, batch_size=int(cfg.get("batch_size", 8)),
                                      batch_bins=int(cfg.get("batch_bins", 1000000)))
        collate = CommonCollateFn(pad_multiples={
            "speech": int(cfg.get("speech_pad_multiple", 1600)),
            "text": int(cfg.get("text_pad_multiple", 8)),
        })
        return SequenceIterFactory(dataset, batches, collate, shuffle=shuffle,
                                   seed=int(cfg.get("seed", 0)), device=self.device)

    @torch.no_grad()
    def collect_stats(self) -> Path:
        """feats_stats.npz of the train dataset (the frontend in float32 on
        the device, summed in numpy as the JAX package sums it); the file
        goes into the config's ``normalize_conf.stats_file``."""
        from llm_guided_asr_tpu_torch.tasks.asr import FeatsStats, build_model

        model = build_model({**self.config, "_skip_llm_weights": True}, self.device).eval()
        acc = FeatsStats(model)
        for uid in self.train_dataset.keys:
            acc.add(self.train_dataset[uid]["speech"])
        self.output_dir.mkdir(parents=True, exist_ok=True)
        stats = self.output_dir / "feats_stats.npz"
        acc.save(stats)
        self.config.setdefault("normalize_conf", {})["stats_file"] = str(stats)
        return stats

    def train(self):
        """Train; returns the final TrainState."""
        from llm_guided_asr_tpu_torch.convert import init_weights
        from llm_guided_asr_tpu_torch.tasks.asr import (
            apply_init_param,
            build_model,
            init_model_variables,
            translate_param_path,
        )
        from llm_guided_asr_tpu_torch.tasks.lm import build_lm
        from llm_guided_asr_tpu_torch.train.optim import build_optimizer, path_prefix_mask
        from llm_guided_asr_tpu_torch.train.trainer import Trainer as CoreTrainer
        from llm_guided_asr_tpu_torch.train.trainer import TrainerOptions
        from llm_guided_asr_tpu_torch.utils.config import dump_yaml

        cfg = self.config
        self.output_dir.mkdir(parents=True, exist_ok=True)
        dump_yaml({k: v for k, v in cfg.items() if not k.startswith("_")},
                  self.output_dir / "config.yaml")
        seed = int(cfg.get("seed", 0))
        exclude = ("params/llm",) if cfg.get("model") == "llm_guided_asr" else ()
        if self.task == "lm":
            model = init_weights(build_lm(cfg, self.device), seed)
            batch_args = ("text", "text_lengths")
        elif self.task == "st":
            # the ST model of tasks/st.py (the JAX ez.Trainer builds the
            # ASR task's model from the ST defaults instead)
            from llm_guided_asr_tpu_torch.tasks.st import (
                ST_BATCH_ARGS,
                build_st_model,
                init_st_variables,
            )

            model = init_st_variables(build_st_model(cfg, self.device), cfg, seed)
            batch_args, exclude = ST_BATCH_ARGS, ("params/llm",)
        else:
            model = init_model_variables(build_model(cfg, self.device), cfg, seed)
            if cfg.get("init_param"):
                apply_init_param(model, cfg["init_param"])
            batch_args = ("speech", "speech_lengths", "text", "text_lengths")
        freeze = [translate_param_path(f) for f in (cfg.get("freeze_param") or [])]
        if cfg.get("model") in ("llm_guided_asr", "llm_guided_st") and "llm" not in freeze:
            freeze.append("llm")
        tx = build_optimizer(cfg.get("optim", "adam"), cfg.get("optim_conf"),
                             cfg.get("scheduler"), cfg.get("scheduler_conf"),
                             grad_clip=cfg.get("grad_clip", 5.0),
                             freeze_mask=path_prefix_mask(model, freeze) if freeze else ())
        options = TrainerOptions(
            max_epoch=int(cfg.get("max_epoch", 10)),
            accum_grad=int(cfg.get("accum_grad", 1)),
            log_interval=int(cfg.get("log_interval", 100)),
            patience=cfg.get("patience"),
            keep_nbest_models=int(cfg.get("keep_nbest_models", 3)),
            best_model_criterion=[tuple(c) for c in cfg.get("best_model_criterion")],
            resume=bool(cfg.get("resume", False)),
            seed=seed,
            exclude_prefixes=exclude,
            batch_args=batch_args,
        )
        return CoreTrainer.run(model, tx, self._iter_factory(self.train_dataset, True),
                               self._iter_factory(self.valid_dataset, False),
                               self.output_dir, options)
