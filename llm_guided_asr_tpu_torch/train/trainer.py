"""The fused train step (counterpart of llm_guided_asr_tpu/train/trainer.py
``init_train_state`` and ``make_fused_train_step``).

One call of the step: forward in train mode -> loss -> backward ->
[non-finite gradients skip the update] -> global-norm clip -> optimizer
update with the schedule's learning rate.  A skipped update leaves the
parameters, the optimizer state and the update count as they were, while
the batch-norm running statistics move as the forward moved them (the
JAX step returns ``new_extra`` either way).  The finite check reads the
global norm once per step, and each gradient's finiteness only when that
norm is not finite.  ``Trainer.run``,
checkpoints, the reporter and gradient accumulation are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch
from torch import nn

from llm_guided_asr_tpu_torch.train.optim import OptimizerSpec
from llm_guided_asr_tpu_torch.utils.rng import StepRNG

BATCH_ARGS = ("speech", "speech_lengths", "text", "text_lengths")  # the model's positional inputs


@dataclasses.dataclass
class TrainState:
    """The torch optimizer bound to the model's trainable parameters, its
    update count and the spec it came from."""

    optimizer: torch.optim.Optimizer
    spec: OptimizerSpec
    step: int = 0

    @property
    def params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def init_train_state(model: nn.Module, tx: OptimizerSpec) -> TrainState:
    return TrainState(tx.init(model), tx)


def make_fused_train_step(model: nn.Module, state: TrainState, generator: torch.Generator
                          ) -> Callable[[Mapping[str, torch.Tensor]],
                                        Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """step(batch) -> (stats, weight), updating ``model`` and ``state`` in
    place.  ``generator`` is a CPU torch.Generator; each step draws its
    StepRNG (dropout, SpecAug, the attention kernel's seeds) from it."""
    if generator.device.type != "cpu":
        raise ValueError("make_fused_train_step: the generator must be a CPU torch.Generator")
    device = next(model.parameters()).device
    clip = state.spec.grad_clip

    def step(batch: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        model.train()
        params = state.params
        loss, stats, weight = model(*(batch[k] for k in BATCH_ARGS),
                                    rng=StepRNG(generator, device))
        for p in params:
            p.grad = None
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads))) if grads else torch.zeros(())
        # one host read per step while the norm is finite; past float32's
        # range a second read tells a non-finite gradient (skip the update)
        # from finite ones whose norm overflowed (clipped to 0 and applied,
        # as optax does)
        if bool(torch.isfinite(norm)) or bool(
                torch.stack([torch.isfinite(g).all() for g in grads]).all()):
            if clip is not None and clip > 0:
                scale = torch.clamp(clip / norm, max=1.0)  # optax.clip_by_global_norm
                torch._foreach_mul_(grads, scale)
            for p, g in zip(params, grads):
                p.grad = g
            lr = state.spec.schedule(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            state.step += 1
        for p in params:
            p.grad = None
        return {k: v.detach() for k, v in stats.items()}, weight

    return step
