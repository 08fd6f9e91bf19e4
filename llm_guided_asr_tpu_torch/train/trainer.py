"""The training loop (counterpart of llm_guided_asr_tpu/train/trainer.py).

Rebuild of espnet2/train/trainer.py:109 (Trainer.run / train_one_epoch /
validate_one_epoch): epochs of train steps, validation, checkpoints with
n-best retention and averaging (train/checkpoint.py), resume from
``checkpoint.pth`` and ``reporter.json``, early stopping, and the
validation-driven plateau scale.

The update: [non-finite gradients skip it] -> global-norm clip ->
[gradient noise] -> optimizer with the schedule's learning rate ->
[plateau scale].  A skipped update leaves the parameters, the optimizer
state and the update count as they were, while the batch-norm running
statistics move as the forward moved them (the JAX step returns
``new_extra`` either way).  The finite check reads the global norm once
per update, and each gradient's finiteness only when that norm is not
finite.  Each microbatch's backward runs on ``loss / accum_grad`` and
accumulates into ``.grad`` (reading nothing from the device), and every
``accum_grad`` microbatches :func:`apply_update` applies the sum; a tail
with fewer microbatches is applied at the end of the epoch.  At
``accum_grad == 1`` that is :func:`make_fused_train_step`, one update a
batch: JAX fuses it into one jit, which PyTorch has no use for, so only the
probe's reporter key (``train_step_time`` for ``grad_time`` and
``optim_step_time``) tells the two apart.

Random state: each epoch's CPU generator is seeded from ``(seed, epoch)``
alone, as JAX folds the epoch into its key, so a run resumed after epoch
2 draws the dropout and SpecAug masks of an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.train.checkpoint import CheckpointManager, merge_loaded
from llm_guided_asr_tpu_torch.train.optim import OptimizerSpec, PlateauController
from llm_guided_asr_tpu_torch.train.reporter import Reporter
from llm_guided_asr_tpu_torch.utils.rng import StepRNG

logger = logging.getLogger(__name__)

BATCH_ARGS = ("speech", "speech_lengths", "text", "text_lengths")  # the model's positional inputs
BatchArgs = Union[Tuple[str, ...], Callable[[Mapping], tuple]]


@dataclasses.dataclass
class TrainerOptions:
    """Every field of the JAX TrainerOptions (trainer.py:77-106 of the
    reference).  The mesh fields (``data_parallel``, ``model_parallel``,
    ``sharded_optim``, ``llm_prefix``) raise NotImplementedError away from
    their defaults: multi-card training is not ported yet (ROADMAP Queue 1
    item 11).  ``rng_impl`` is accepted and selects nothing: the port's
    dropout masks come from torch generators and the attention kernel's
    counter hash, not from a JAX PRNG.  ``flat_optim`` runs the same update
    as the per-leaf path (``tests/test_flat_optim.py`` holds the two equal in
    JAX): the port's optimizers are multi-tensor (``torch._foreach_*``)
    already.  ``grad_noise`` is read by ``build_optimizer`` (as in JAX, the
    task passes it there)."""

    max_epoch: int = 40
    accum_grad: int = 1
    grad_noise: bool = False
    log_interval: int = 100
    patience: Optional[int] = None
    keep_nbest_models: int = 10
    best_model_criterion: Sequence[Tuple[str, str, str]] = (("valid", "loss", "min"),)
    # phase/key driving the epoch-level plateau scale; read only when
    # plateau_conf is set (the optimizer built with scheduler=reducelronplateau)
    val_scheduler_criterion: Tuple[str, str] = ("valid", "loss")
    plateau_conf: Optional[Dict] = None  # factor/patience/threshold/min_scale
    resume: bool = False
    seed: int = 0
    exclude_prefixes: Sequence[str] = ()  # e.g. ("params/llm",)
    average_criterion: Optional[Tuple[str, str, str]] = None  # default: first best criterion
    batch_args: BatchArgs = BATCH_ARGS
    use_tensorboard: bool = False
    use_wandb: bool = False
    wandb_project: Optional[str] = None
    wandb_name: Optional[str] = None
    report_ctc_er: bool = False  # greedy-CTC token error rate on valid
    # task-defined extra validation: model -> {stat: float}, registered into
    # the 'valid' phase once per epoch (spk_trainer.py:87-215)
    epoch_eval_fn: Optional[Callable[[nn.Module], Dict[str, float]]] = None
    data_parallel: Optional[int] = None
    model_parallel: int = 1
    llm_prefix: str = "llm"
    sharded_optim: bool = False
    rng_impl: str = "rbg"
    flat_optim: bool = False

    def __post_init__(self):
        mesh = {"data_parallel": None, "model_parallel": 1, "sharded_optim": False,
                "llm_prefix": "llm"}
        changed = sorted(k for k, v in mesh.items() if getattr(self, k) != v)
        if changed:
            raise NotImplementedError(f"TrainerOptions {changed}: multi-card training is not "
                                      "ported yet (ROADMAP Queue 1 item 11)")
        if self.accum_grad < 1:
            raise ValueError(f"accum_grad must be >= 1, got {self.accum_grad}")


@dataclasses.dataclass
class TrainState:
    """The torch optimizer bound to the model's trainable parameters, the
    count of applied updates (the schedule's count), the plateau scale, the
    spec it came from, and (file, seconds, bytes) of each checkpoint save
    of this process."""

    optimizer: torch.optim.Optimizer
    spec: OptimizerSpec
    step: int = 0
    plateau_scale: float = 1.0
    saves: List[Tuple[str, float, int]] = dataclasses.field(default_factory=list)

    @property
    def params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def init_train_state(model: nn.Module, tx: OptimizerSpec) -> TrainState:
    return TrainState(tx.init(model), tx)


def _call(model: nn.Module, batch: Mapping, batch_args: BatchArgs, **kw):
    """The model on a batch: ``batch_args`` names its positional inputs, or
    maps the batch to a tuple of them or to a dict of keyword inputs (the
    guided model's ``bias_words``/``ctc_text`` follow its ``rng``)."""
    args = batch_args(batch) if callable(batch_args) else tuple(batch[k] for k in batch_args)
    if isinstance(args, Mapping):
        return model(**args, **kw)
    return model(*args, **kw)


def apply_update(state: TrainState) -> bool:
    """Apply the gradients in the parameters' ``.grad`` (None counts as 0)
    and clear them; returns whether the update was applied."""
    params = state.params
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads))) if grads else torch.zeros(())
    # one host read per update while the norm is finite; past float32's
    # range a second read tells a non-finite gradient (skip the update)
    # from finite ones whose norm overflowed (clipped to 0 and applied, as
    # optax does)
    applied = bool(torch.isfinite(norm)) or bool(
        torch.stack([torch.isfinite(g).all() for g in grads]).all())
    if applied:
        clip = state.spec.grad_clip
        if clip is not None and clip > 0:
            scale = torch.clamp(clip / norm, max=1.0)  # optax.clip_by_global_norm
            torch._foreach_mul_(grads, scale)
        if state.spec.grad_noise:
            state.spec.add_noise(grads, state.step)
        for p, g in zip(params, grads):
            p.grad = g
        state.spec.set_lr(state.optimizer, state.step, state.plateau_scale)
        state.optimizer.step()
        state.step += 1
    for p in params:
        p.grad = None
    return applied


def make_fused_train_step(model: nn.Module, state: TrainState, generator: torch.Generator,
                          batch_args: BatchArgs = BATCH_ARGS
                          ) -> Callable[[Mapping[str, torch.Tensor]],
                                        Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """step(batch) -> (stats, weight), updating ``model`` and ``state`` in
    place: :func:`make_grad_step` on fresh gradients, then
    :func:`apply_update`.  ``generator`` is a CPU torch.Generator; each
    step draws its StepRNG (dropout, SpecAug, the attention kernel's seeds)
    from it, and the caller may reseed it between steps."""
    grad_step = make_grad_step(model, generator, 1, batch_args)

    def step(batch: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        for p in state.params:
            p.grad = None
        out = grad_step(batch)
        apply_update(state)
        return out

    return step


def make_grad_step(model: nn.Module, generator: torch.Generator, accum_grad: int = 1,
                   batch_args: BatchArgs = BATCH_ARGS
                   ) -> Callable[[Mapping[str, torch.Tensor]],
                                 Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """grad_step(batch) -> (stats, weight): forward in train mode and the
    backward of ``loss / accum_grad``, accumulated into ``.grad``; the
    caller applies the sum with :func:`apply_update`."""
    if generator.device.type != "cpu":
        raise ValueError("the step's generator must be a CPU torch.Generator")
    device = next(model.parameters()).device

    def grad_step(batch: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor],
                                                               torch.Tensor]:
        model.train()
        loss, stats, weight = _call(model, batch, batch_args, rng=StepRNG(generator, device))
        (loss / accum_grad).backward()
        return {k: v.detach() for k, v in stats.items()}, weight

    return grad_step


class DeviceStatAccumulator:
    """On-device running (sum, weight) of per-step stats: nothing is read
    from the device until :meth:`flush`, once per log_interval (the
    reference likewise aggregates and logs every log_interval,
    espnet2/train/reporter.py:153 SubReporter)."""

    def __init__(self):
        self._sums: Optional[Dict[str, torch.Tensor]] = None
        self._weight: Optional[torch.Tensor] = None
        self._count = 0

    def add(self, stats: Mapping[str, torch.Tensor], weight):
        w32 = torch.as_tensor(weight, dtype=torch.float32)
        contrib = {k: v.float() * w32 for k, v in stats.items() if v is not None}
        if self._sums is None:
            self._sums, self._weight = contrib, w32
        else:
            for k, v in contrib.items():
                self._sums[k] = self._sums[k] + v if k in self._sums else v
            self._weight = self._weight + w32
        self._count += 1

    def flush(self) -> Optional[Tuple[Dict[str, float], float]]:
        """One transfer; returns (mean stats, total weight) or None, and resets."""
        if self._sums is None or self._count == 0:
            return None
        keys = list(self._sums)
        values = torch.stack([self._sums[k] for k in keys] + [self._weight]).tolist()
        w = values[-1]
        means = {k: v / w for k, v in zip(keys, values)} if w > 0 else {}
        self._sums, self._weight, self._count = None, None, 0
        return means, w


def make_valid_step(model: nn.Module, batch_args: BatchArgs = BATCH_ARGS):
    """valid_step(batch) -> (stats as floats, weight): eval mode, no grad."""

    @torch.no_grad()
    def valid_step(batch: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, float], float]:
        model.eval()
        _, stats, weight = _call(model, batch, batch_args)
        keys = list(stats)
        values = torch.stack([stats[k].float() for k in keys]
                             + [torch.as_tensor(weight, dtype=torch.float32)]).tolist()
        return dict(zip(keys, values[:-1])), values[-1]

    return valid_step


def make_ctc_greedy_step(model: nn.Module):
    """Greedy-CTC hypotheses for validation error reporting (ErrorCalculator
    cer_ctc, llm_guided_asr_model.py:180-182); None for a model without a
    CTC head."""
    if not hasattr(model, "ctc_log_softmax") or not hasattr(model, "ctc_head"):
        return None
    from llm_guided_asr_tpu_torch.search.greedy import ctc_greedy_decode

    @torch.no_grad()
    def greedy(speech: torch.Tensor, speech_lengths: torch.Tensor):
        model.eval()
        enc, enc_lens = model.encode(speech, speech_lengths)
        return ctc_greedy_decode(model.ctc_log_softmax(enc), enc_lens)

    return greedy


def token_error_rate(hyp_tokens, hyp_lens, ref_tokens, ref_lens) -> float:
    """Corpus token error rate (percent) of a batch, on the host."""
    from llm_guided_asr_tpu_torch.utils.metrics import error_rate

    def rows(tokens, lens):
        tokens = torch.as_tensor(tokens).cpu().tolist()
        return [row[:n] for row, n in zip(tokens, torch.as_tensor(lens).cpu().tolist())]

    return error_rate(rows(ref_tokens, ref_lens), rows(hyp_tokens, hyp_lens))["err"]


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of an epoch's generator, from (seed, epoch) alone."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """The epoch loop (classmethod style like the reference Trainer.run)."""

    @classmethod
    def run(
        cls,
        model: nn.Module,
        tx: OptimizerSpec,
        train_iter_factory: Callable[[int], Iterable[Dict]],
        valid_iter_factory: Callable[[int], Iterable[Dict]],
        output_dir: Union[str, Path],
        options: TrainerOptions,
    ) -> TrainState:
        """Train ``model`` in place; returns the final TrainState.  The
        factories map an epoch (from 1) to its batches, on the model's
        device (data/iterator.py SequenceIterFactory)."""
        output_dir = Path(output_dir)
        reporter = Reporter()
        ckpt = CheckpointManager(output_dir, keep_nbest=options.keep_nbest_models,
                                 best_criteria=options.best_model_criterion,
                                 exclude_prefixes=options.exclude_prefixes)
        state = init_train_state(model, tx)
        start_epoch = 1
        if options.resume and ckpt.has_checkpoint():
            loaded = ckpt.load_checkpoint()
            merge_loaded(model, loaded["model"])
            state.optimizer.load_state_dict(loaded["optimizer"])
            state.step = int(loaded["step"])
            state.plateau_scale = float(loaded["plateau_scale"])
            reporter = Reporter.load(output_dir / "reporter.json")
            start_epoch = reporter.epoch + 1
            logger.info(f"resumed from epoch {reporter.epoch}")

        device = next(model.parameters()).device
        bargs = options.batch_args if callable(options.batch_args) else tuple(options.batch_args)
        generator = torch.Generator()
        grad_step = make_grad_step(model, generator, options.accum_grad, bargs)
        for p in state.params:
            p.grad = None
        valid_step = make_valid_step(model, bargs)
        greedy_step = make_ctc_greedy_step(model) if options.report_ctc_er else None

        # ---- val-driven epoch scale (ReduceLROnPlateau analog) ----
        plateau_ctl = None
        if options.plateau_conf is not None:
            if not tx.plateau:
                raise ValueError("optimizer was not built with a plateau scheduler")
            plateau_ctl = PlateauController(**options.plateau_conf)
            vphase, vkey = options.val_scheduler_criterion
            # resume: the controller is host-side state; rebuild it from the
            # saved reporter history so the scale continues, not resets
            hist = [reporter.stats[e][vphase][vkey] for e in sorted(reporter.stats)
                    if vkey in reporter.stats[e].get(vphase, {})]
            if hist:
                state.plateau_scale = plateau_ctl.replay(hist)

        tb_writer = None
        if options.use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                tb_writer = SummaryWriter(log_dir=str(output_dir / "tensorboard"))
            except Exception as e:  # pragma: no cover
                logger.warning(f"tensorboard unavailable: {e}")
        wandb_run = None
        if options.use_wandb:
            try:
                import wandb

                wandb_run = wandb.init(project=options.wandb_project, name=options.wandb_name)
            except Exception as e:  # pragma: no cover
                logger.warning(f"wandb unavailable: {e}")

        for epoch in range(start_epoch, options.max_epoch + 1):
            reporter.set_epoch(epoch)
            generator.manual_seed(epoch_seed(options.seed, epoch))

            # ---- train ----
            sub = reporter.start_phase("train")
            cls._train_one_epoch(state, grad_step, train_iter_factory(epoch), options, sub,
                                 device)
            reporter.finish_phase(sub)

            # ---- validate ----
            sub = reporter.start_phase("valid")
            for batch in valid_iter_factory(epoch):
                batch = {k: v for k, v in batch.items() if not k.startswith("_")}
                stats, weight = valid_step(batch)
                if greedy_step is not None and "speech" in batch:
                    hyp_t, hyp_n = greedy_step(batch["speech"], batch["speech_lengths"])
                    stats["cer_ctc"] = token_error_rate(hyp_t, hyp_n, batch["text"],
                                                        batch["text_lengths"])
                sub.register(stats, weight)
            if options.epoch_eval_fn is not None:
                extra_stats = options.epoch_eval_fn(model)
                if extra_stats:
                    sub.register({k: float(v) for k, v in extra_stats.items()}, 1.0)
            reporter.finish_phase(sub)
            reporter.log_epoch()

            # ---- external observability (reporter.py:220,233) ----
            for phase, stats in reporter.stats.get(epoch, {}).items():
                for k, v in stats.items():
                    if not isinstance(v, float):
                        continue
                    if tb_writer is not None:
                        tb_writer.add_scalar(f"{phase}/{k}", v, epoch)
                    if wandb_run is not None:
                        wandb_run.log({f"{phase}/{k}": v, "epoch": epoch})

            # ---- val-driven scale, stepped before the checkpoint so that
            # the saved state carries the current scale ----
            if plateau_ctl is not None:
                vphase, vkey = options.val_scheduler_criterion
                val = reporter.get(epoch, vphase, vkey)
                if val is not None:
                    state.plateau_scale = plateau_ctl.step(float(val))
                    if state.plateau_scale != 1.0:
                        logger.info(f"plateau LR scale: {state.plateau_scale:g}")

            # ---- checkpoint ----
            state.saves.extend(ckpt.save_epoch(epoch, model, state.optimizer, state.step,
                                               state.plateau_scale, reporter))

            # ---- early stop ----
            if options.patience is not None:
                phase, key, mode = options.best_model_criterion[0]
                if reporter.check_early_stopping(options.patience, phase, key, mode):
                    break

        # ---- final n-best average (trainer.py:533-540) ----
        crit = options.average_criterion or options.best_model_criterion[0]
        try:
            ckpt.average_nbest(reporter, *crit)
        except RuntimeError:
            logger.warning("n-best averaging skipped (no epochs)")
        return state

    @staticmethod
    def _train_one_epoch(state: TrainState, grad_step, iterator, options, sub,
                         device: torch.device):
        fused = options.accum_grad == 1  # JAX's reporter keys: train_step_time
        n_acc = 0
        # stats stay on the device between log points
        stat_acc = DeviceStatAccumulator()
        t0 = time.perf_counter()
        # phase timing (SubReporter.measure_time, reporter.py:255): timing
        # every step would synchronize every step, so one synchronized step
        # per log interval is probed instead
        phase_times: Dict[str, float] = {}
        t_iter = time.perf_counter()
        for it, batch in enumerate(iterator):
            iter_time = time.perf_counter() - t_iter
            batch = {k: v for k, v in batch.items() if not k.startswith("_")}
            probe = (it + 1) % options.log_interval == 0
            if probe:
                _sync(device)
                tg = time.perf_counter()
            stats, weight = grad_step(batch)
            if probe and not fused:
                _sync(device)
                phase_times["grad_time"] = time.perf_counter() - tg
            n_acc += 1
            if n_acc == options.accum_grad:
                to = time.perf_counter()
                apply_update(state)
                n_acc = 0
                if probe:
                    _sync(device)
                    t = time.perf_counter()
                    phase_times.update({"train_step_time": t - tg} if fused
                                       else {"optim_step_time": t - to})
            stat_acc.add(stats, weight)
            if probe:
                flushed = stat_acc.flush()
                if flushed is not None:
                    means, w = flushed
                    sub.register({**means, **phase_times, "iter_time": iter_time}, w)
                    sub.log_interval(1, extra=f"(iter {it + 1}, update {state.step})")
                # only the phases measured this interval: with accum_grad > 1
                # most probes miss the update
                phase_times = {}
            t_iter = time.perf_counter()
        if n_acc > 0:
            apply_update(state)
        flushed = stat_acc.flush()
        if flushed is not None:
            sub.register(*flushed)
        logger.info(f"epoch took {time.perf_counter() - t0:.1f}s ({state.step} updates in all)")
