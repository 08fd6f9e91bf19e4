"""Learning-rate schedules and the optimizer chain (counterpart of llm_guided_asr_tpu/train/optim.py).

A schedule maps the update count (0 for the first update, as optax counts)
to a learning rate.  :func:`build_optimizer` returns an
:class:`OptimizerSpec`, the port's counterpart of the optax chain
[zero the frozen gradients] -> global-norm clip -> Adam/AdamW(schedule);
:meth:`OptimizerSpec.init` binds it to a model.  Frozen parameters are
named by :func:`path_prefix_mask`; they get ``requires_grad_(False)`` and
no optimizer state, so they neither move nor count in the clip norm.
Only adam and adamw are ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Iterable, Optional, Sequence

import torch
from torch import nn

Schedule = Callable[[int], float]


def warmup_lr(lr: float, warmup_steps: int = 25000, **_unused) -> Schedule:
    """espnet2/schedulers/warmuplr.py: lr * w^0.5 * min(s^-0.5, s * w^-1.5), s = step + 1."""

    def schedule(step: int) -> float:
        s = max(step + 1.0, 1.0)
        w = float(warmup_steps)
        return lr * w**0.5 * min(s**-0.5, s * w**-1.5)

    return schedule


def noam_lr(lr: float, model_size: int = 320, warmup_steps: int = 25000, **_unused) -> Schedule:
    """espnet2/schedulers/noamlr.py: warmuplr scaled by model_size^-0.5."""

    def schedule(step: int) -> float:
        s = max(step + 1.0, 1.0)
        w = float(warmup_steps)
        return lr * model_size**-0.5 * min(s**-0.5, s * w**-1.5)

    return schedule


def constant_lr(lr: float, **_unused) -> Schedule:
    return lambda step: lr


SCHEDULER_REGISTRY: Dict[str, Callable[..., Schedule]] = {
    "warmuplr": warmup_lr,
    "noamlr": noam_lr,
    "none": constant_lr,
    "constant": constant_lr,
}


def build_schedule(name: Optional[str], lr: float, conf: Optional[dict] = None) -> Schedule:
    name = (name or "none").lower()
    if name not in SCHEDULER_REGISTRY:
        raise NotImplementedError(f"scheduler {name!r} is not ported yet")
    conf = dict(conf or {})
    conf.pop("lr", None)
    return SCHEDULER_REGISTRY[name](lr, **conf)


def path_prefix_mask(model: nn.Module, prefixes: Sequence[str]) -> FrozenSet[str]:
    """Names of the parameters whose path starts with any prefix (a whole
    path component: 'encoder' matches 'encoder.x', not 'encoder2.x');
    '/' and '.' both separate components.  freeze_param semantics."""
    prefs = [p.replace("/", ".") for p in prefixes]
    return frozenset(
        name for name, _ in model.named_parameters()
        if any(name == p or name.startswith(p + ".") for p in prefs)
    )


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Everything of the update chain but the model it applies to."""

    name: str
    kwargs: Dict[str, object]
    schedule: Schedule
    grad_clip: Optional[float]
    frozen: FrozenSet[str]

    def init(self, model: nn.Module) -> torch.optim.Optimizer:
        """Freeze the ``frozen`` parameters and build the torch optimizer
        over the others, with the learning rate of the first update."""
        params = []
        for name, p in model.named_parameters():
            if name in self.frozen:
                p.requires_grad_(False)
            else:
                params.append(p)
        cls = torch.optim.AdamW if self.name == "adamw" else torch.optim.Adam
        return cls(params, lr=self.schedule(0), **self.kwargs)


def build_optimizer(name: str = "adam", conf: Optional[dict] = None,
                    scheduler: Optional[str] = None, scheduler_conf: Optional[dict] = None,
                    grad_clip: Optional[float] = 5.0,
                    freeze_mask: Iterable[str] = ()) -> OptimizerSpec:
    """The update chain: [frozen out] -> clip by global norm ``grad_clip``
    -> optimizer(schedule).  ``conf`` takes lr, betas, eps and
    weight_decay.  adam with weight_decay > 0 is AdamW (decoupled decay),
    as optax.adamw is in the JAX package; adamw defaults to 0.01."""
    conf = dict(conf or {})
    lr = float(conf.pop("lr", 1e-3))
    key = name.lower()
    if key not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (adam, adamw are)")
    betas = tuple(conf.pop("betas", (0.9, 0.999)))
    eps = float(conf.pop("eps", 1e-8))
    weight_decay = float(conf.pop("weight_decay", 0.01 if key == "adamw" else 0.0))
    if conf:
        raise ValueError(f"build_optimizer: unknown options {sorted(conf)}")
    if weight_decay:
        key = "adamw"
    kwargs = {"betas": betas, "eps": eps}
    if key == "adamw":
        kwargs["weight_decay"] = weight_decay
    return OptimizerSpec(key, kwargs, build_schedule(scheduler, lr, scheduler_conf),
                         grad_clip, frozenset(freeze_mask))
