"""Learning-rate schedules and the optimizer chain (counterpart of
llm_guided_asr_tpu/train/optim.py).

A schedule maps the update count (0 for the first update, as optax counts)
to a learning rate.  :func:`build_optimizer` returns an
:class:`OptimizerSpec`, the port's counterpart of the optax chain
[zero the frozen gradients] -> global-norm clip -> [gradient noise] ->
optimizer(schedule) -> [plateau scale]; :meth:`OptimizerSpec.init` binds
it to a model.  Frozen parameters are named by :func:`path_prefix_mask`;
they get ``requires_grad_(False)`` and no optimizer state, so they neither
move nor count in the clip norm.

adam and adamw run on ``torch.optim.Adam``/``AdamW``, whose arithmetic is
optax's.  The other optimizers of the registry compute optax's update
(optax 0.2.6), not ``torch.optim``'s, which differs where it shows:
adagrad's accumulator starts at 0.1 with eps inside the root, rmsprop's
eps sits inside the root and its momentum traces the lr-scaled update,
radam's rectification and eps follow ``scale_by_radam``, adafactor
factors the second moment of dims >= 128, decays at 1 - (t+1)^-0.8,
clips the block RMS at 1 and scales by the parameter's RMS; lamb and lion
have no torch class.  Their bias corrections take ``b ** count`` in
float32 by repeated squaring, as XLA does, because radam's rectification
term cancels 1999 - 1994 at its first updates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence

import numpy as np
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


def exponential_decay_lr(lr: float, decay_rate: float = 0.96, decay_steps: int = 10000,
                         **_unused) -> Schedule:
    """optax.exponential_decay (not staircase): lr * rate^(step / decay_steps)."""
    if decay_steps <= 0 or decay_rate == 0:
        return constant_lr(lr)
    return lambda step: lr if step <= 0 else lr * decay_rate ** (step / decay_steps)


SCHEDULER_REGISTRY: Dict[str, Callable[..., Schedule]] = {
    "warmuplr": warmup_lr,
    "noamlr": noam_lr,
    "none": constant_lr,
    "constant": constant_lr,
    "exponentiallr": exponential_decay_lr,
}

# epoch-level validation-driven schedulers (ReduceLROnPlateau): a constant
# base schedule times a scale that the trainer sets after each validation
PLATEAU_SCHEDULERS = ("reducelronplateau", "plateau")


class PlateauController:
    """Host-side ReduceLROnPlateau logic (torch.optim.lr_scheduler
    semantics: relative threshold); its scale multiplies every update after
    the optimizer, as the JAX chain's ``optax.scale(plateau_scale)`` does."""

    def __init__(self, factor: float = 0.1, patience: int = 3, threshold: float = 1e-4,
                 min_scale: float = 1e-8, mode: str = "min"):
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.min_scale = float(min_scale)
        self.mode = mode
        self.scale = 1.0
        self.best: Optional[float] = None
        self.num_bad = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float) -> float:
        if self._improved(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.num_bad = 0
        return self.scale

    def replay(self, values) -> float:
        """Rebuild the state from a metric history (resume: the reporter is
        saved, the controller is not)."""
        for v in values:
            self.step(v)
        return self.scale


def build_schedule(name: Optional[str], lr: float, conf: Optional[dict] = None) -> Schedule:
    name = (name or "none").lower()
    if name not in SCHEDULER_REGISTRY:
        raise ValueError(f"unknown scheduler {name!r}; known: {sorted(SCHEDULER_REGISTRY)} "
                         f"and {PLATEAU_SCHEDULERS}")
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


# ---------------------------------------------------------------------------
# optax's optimizers as torch optimizers
# ---------------------------------------------------------------------------

def _f32_pow(base: float, count: int) -> np.float32:
    """``base ** count`` in float32 by repeated squaring: XLA's integer
    power, bit for bit (optax's bias corrections)."""
    result, x, n = np.float32(1.0), np.float32(base), int(count)
    while n:
        if n & 1:
            result = np.float32(result * x)
        x = np.float32(x * x)
        n >>= 1
    return result


class OptaxOptimizer(torch.optim.Optimizer):
    """Base of the optimizers that follow optax's arithmetic.  A group's
    ``lr`` is the schedule's value for this update and ``plateau_scale``
    the scale applied after the optimizer; :meth:`updates` returns the
    optax update of each parameter (the step is ``p += scale * u``)."""

    def __init__(self, params, lr: float, **defaults):
        super().__init__(params, dict(lr=lr, plateau_scale=1.0, **defaults))

    def init_state(self, group: dict, p: torch.Tensor) -> dict:
        raise NotImplementedError

    def updates(self, group: dict, params: List[torch.Tensor], grads: List[torch.Tensor],
                states: List[dict]) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}: closures are not supported")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                if not self.state[p]:
                    self.state[p].update(self.init_state(group, p))
                    self.state[p]["count"] = 0
                states.append(self.state[p])
            count = states[0]["count"]
            ups = self.updates(group, params, [p.grad for p in params], states)
            if group["plateau_scale"] != 1.0:
                torch._foreach_mul_(ups, group["plateau_scale"])
            torch._foreach_add_(params, ups)
            for s in states:
                s["count"] = count + 1


def _add_decayed(grads, params, wd):
    """optax.add_decayed_weights: g + wd * p (new tensors; without decay the
    gradients themselves, which the caller must not write into)."""
    return torch._foreach_add(grads, params, alpha=wd) if wd else list(grads)


def _bias_corrected(moments, b, count):
    return torch._foreach_div(moments, float(np.float32(1.0) - _f32_pow(b, count)))


class SGD(OptaxOptimizer):
    """optax.sgd, with weight decay coupled before it (add_decayed_weights)."""

    def __init__(self, params, lr, momentum=0.0, nesterov=False, weight_decay=0.0):
        super().__init__(params, lr, momentum=momentum, nesterov=nesterov,
                         weight_decay=weight_decay)

    def init_state(self, group, p):
        return {"trace": torch.zeros_like(p)} if group["momentum"] else {}

    def updates(self, group, params, grads, states):
        g = _add_decayed(grads, params, group["weight_decay"])
        if group["momentum"]:
            mom = group["momentum"]
            trace = [s["trace"] for s in states]
            torch._foreach_mul_(trace, mom)
            torch._foreach_add_(trace, g)  # t = g + momentum * t
            g = torch._foreach_add(g, trace, alpha=mom) if group["nesterov"] else trace
        # out of place: g may be the gradients (optax's update is functional)
        return torch._foreach_mul(g, -group["lr"])


class Adadelta(OptaxOptimizer):
    """optax.adadelta (scale_by_adadelta), weight decay coupled before it."""

    def __init__(self, params, lr, rho=0.95, eps=1e-6, weight_decay=0.0):
        super().__init__(params, lr, rho=rho, eps=eps, weight_decay=weight_decay)

    def init_state(self, group, p):
        return {"e_g": torch.zeros_like(p), "e_x": torch.zeros_like(p)}

    def updates(self, group, params, grads, states):
        rho, eps = group["rho"], group["eps"]
        g = _add_decayed(grads, params, group["weight_decay"])
        e_g = [s["e_g"] for s in states]
        e_x = [s["e_x"] for s in states]
        torch._foreach_mul_(e_g, rho)
        torch._foreach_add_(e_g, torch._foreach_mul(g, g), alpha=1 - rho)
        num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        u = torch._foreach_mul(torch._foreach_div(num, den), g)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_add_(e_x, torch._foreach_mul(u, u), alpha=1 - rho)
        torch._foreach_mul_(u, -group["lr"])
        return u


ADAGRAD_INITIAL_ACCUMULATOR = 0.1


class Adagrad(OptaxOptimizer):
    """optax.adagrad: the sum of squares starts at 0.1, then
    g * rsqrt(sum + eps) (0 where the sum is 0)."""

    def __init__(self, params, lr, eps=1e-10):
        super().__init__(params, lr, eps=eps)

    def init_state(self, group, p):
        return {"sum_of_squares": torch.full_like(p, ADAGRAD_INITIAL_ACCUMULATOR)}

    def updates(self, group, params, grads, states):
        acc = [s["sum_of_squares"] for s in states]
        torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
        out = []
        for a, g in zip(acc, grads):
            inv = torch.where(a > 0, torch.rsqrt(a + group["eps"]), 0.0)
            out.append(inv * g * -group["lr"])
        return out


class RMSprop(OptaxOptimizer):
    """optax.rmsprop (eps inside the root); momentum traces the update
    after the learning rate, as optax chains them."""

    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0):
        super().__init__(params, lr, alpha=alpha, eps=eps, momentum=momentum)

    def init_state(self, group, p):
        state = {"nu": torch.zeros_like(p)}
        if group["momentum"]:
            state["trace"] = torch.zeros_like(p)
        return state

    def updates(self, group, params, grads, states):
        decay = group["alpha"]
        nu = [s["nu"] for s in states]
        torch._foreach_mul_(nu, decay)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1 - decay)
        u = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, group["eps"])), grads)
        torch._foreach_mul_(u, -group["lr"])
        if group["momentum"]:
            trace = [s["trace"] for s in states]
            torch._foreach_mul_(trace, group["momentum"])
            torch._foreach_add_(trace, u)
            u = torch._foreach_mul(trace, 1.0)
        return u


def _adam_moments(group, grads, states):
    """Adam's first and second moments, updated in place, and their
    bias-corrected copies."""
    b1, b2 = group["betas"]
    mu = [s["mu"] for s in states]
    nu = [s["nu"] for s in states]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1 - b2)
    count = states[0]["count"] + 1
    return _bias_corrected(mu, b1, count), _bias_corrected(nu, b2, count), count


RADAM_THRESHOLD = 5.0


class RAdam(OptaxOptimizer):
    """optax.radam (scale_by_radam): the rectified Adam step once
    rho_t >= 5, the bias-corrected momentum before."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, lr, betas=tuple(betas), eps=eps)

    def init_state(self, group, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def updates(self, group, params, grads, states):
        b2 = group["betas"][1]
        mu_hat, nu_hat, count = _adam_moments(group, grads, states)
        f = np.float32
        ro_inf = f(2.0 / (1.0 - b2) - 1.0)
        b2t = _f32_pow(b2, count)
        ro = f(ro_inf - f(f(2 * count) * b2t) / f(f(1.0) - b2t))
        if ro >= RADAM_THRESHOLD:
            r = f(np.sqrt(f(f(f(ro - f(4.0)) * f(ro - f(2.0))) * ro_inf)
                          / f(f(f(ro_inf - f(4.0)) * f(ro_inf - f(2.0))) * ro)))
            den = torch._foreach_add(torch._foreach_sqrt(nu_hat), group["eps"])
            u = torch._foreach_div(torch._foreach_mul(mu_hat, float(r)), den)
        else:
            u = mu_hat
        torch._foreach_mul_(u, -group["lr"])
        return u


class Lamb(OptaxOptimizer):
    """optax.lamb: the Adam direction plus decoupled weight decay, scaled
    per parameter by ||p|| / ||update|| (1 where either is 0)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0):
        super().__init__(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)

    def init_state(self, group, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def updates(self, group, params, grads, states):
        mu_hat, nu_hat, _ = _adam_moments(group, grads, states)
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), group["eps"])
        u = _add_decayed(torch._foreach_div(mu_hat, den), params, group["weight_decay"])
        p_norm = torch._foreach_norm(params)
        u_norm = torch._foreach_norm(u)
        out = []
        for ui, pn, un in zip(u, p_norm, u_norm):
            ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
            out.append(ui * ratio * -group["lr"])
        return out


class Lion(OptaxOptimizer):
    """optax.lion: sign((1-b1) g + b1 m), then weight decay; m moves at b2."""

    def __init__(self, params, lr, betas=(0.9, 0.99), weight_decay=0.0):
        super().__init__(params, lr, betas=tuple(betas), weight_decay=weight_decay)

    def init_state(self, group, p):
        return {"mu": torch.zeros_like(p)}

    def updates(self, group, params, grads, states):
        b1, b2 = group["betas"]
        mu = [s["mu"] for s in states]
        mixed = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mixed, torch._foreach_mul(mu, b1))
        u = _add_decayed(torch._foreach_sign(mixed), params, group["weight_decay"])
        torch._foreach_mul_(mu, b2)
        torch._foreach_add_(mu, grads, alpha=1 - b2)
        torch._foreach_mul_(u, -group["lr"])
        return u


def _factored_dims(shape, min_dim: int):
    """optax.adafactor's choice: the two largest dims (argsort order) when
    the second largest is >= ``min_dim``, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


# optax.adafactor's defaults, which the registry never overrides
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_MIN_PARAM_SCALE = 1e-3


class Adafactor(OptaxOptimizer):
    """optax.adafactor's defaults: factored second moment (dims >= 128),
    decay 1 - (t+1)^-0.8, eps 1e-30, block-RMS clip at 1, the learning
    rate, then the parameter's RMS (at least 1e-3)."""

    def init_state(self, group, p):
        dims = _factored_dims(p.shape, ADAFACTOR_MIN_DIM_TO_FACTOR)
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": torch.zeros_like(p).mean(dim=d0),
                "v_col": torch.zeros_like(p).mean(dim=d1)}

    def updates(self, group, params, grads, states):
        f = np.float32
        t = f(states[0]["count"] + 1)
        decay = float(f(f(1.0) - t ** f(-ADAFACTOR_DECAY_RATE)))
        out = []
        for p, g, s in zip(params, grads, states):
            g_sqr = g * g + ADAFACTOR_EPS
            dims = _factored_dims(p.shape, ADAFACTOR_MIN_DIM_TO_FACTOR)
            if dims is None:
                s["v"].mul_(decay).add_(g_sqr, alpha=1 - decay)
                u = g * s["v"] ** -0.5
            else:
                d1, d0 = dims
                s["v_row"].mul_(decay).add_(g_sqr.mean(dim=d0), alpha=1 - decay)
                s["v_col"].mul_(decay).add_(g_sqr.mean(dim=d1), alpha=1 - decay)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (s["v_row"] / s["v_row"].mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (s["v_col"] ** -0.5).unsqueeze(d1)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / ADAFACTOR_CLIPPING_THRESHOLD, min=1.0)
            u = u * group["lr"]
            u = u * torch.clamp(torch.sqrt(torch.mean(p * p)), min=ADAFACTOR_MIN_PARAM_SCALE)
            out.append(-u)
        return out


def _adam_kwargs(conf, weight_decay):
    return {"betas": tuple(conf.pop("betas", (0.9, 0.999))), "eps": float(conf.pop("eps", 1e-8)),
            "weight_decay": float(conf.pop("weight_decay", weight_decay))}


def _optimizer_class_and_kwargs(key: str, conf: dict):
    """(torch optimizer class, its kwargs but lr) for a registry name; the
    JAX wrappers' defaults (llm_guided_asr_tpu/train/optim.py:136-181)."""
    if key in ("adam", "adamw"):
        kw = _adam_kwargs(conf, 0.01 if key == "adamw" else 0.0)
        # adam with weight_decay > 0 is optax.adamw (decoupled decay)
        return (torch.optim.AdamW if kw["weight_decay"] else torch.optim.Adam), kw
    if key == "sgd":
        return SGD, {"momentum": float(conf.pop("momentum", 0.0) or 0.0),
                     "nesterov": bool(conf.pop("nesterov", False)),
                     "weight_decay": float(conf.pop("weight_decay", 0.0))}
    if key == "adadelta":
        return Adadelta, {"rho": float(conf.pop("rho", 0.95)), "eps": float(conf.pop("eps", 1e-6)),
                          "weight_decay": float(conf.pop("weight_decay", 0.0))}
    if key == "adagrad":
        return Adagrad, {"eps": float(conf.pop("eps", 1e-10))}
    if key == "rmsprop":
        return RMSprop, {"alpha": float(conf.pop("alpha", 0.99)),
                         "eps": float(conf.pop("eps", 1e-8)),
                         "momentum": float(conf.pop("momentum", 0.0) or 0.0)}
    if key == "radam":
        return RAdam, {"betas": tuple(conf.pop("betas", (0.9, 0.999))),
                       "eps": float(conf.pop("eps", 1e-8))}
    if key == "lamb":
        return Lamb, {"betas": tuple(conf.pop("betas", (0.9, 0.999))),
                      "eps": float(conf.pop("eps", 1e-6)),
                      "weight_decay": float(conf.pop("weight_decay", 0.0))}
    if key == "adafactor":
        return Adafactor, {}
    if key == "lion":
        return Lion, {"betas": tuple(conf.pop("betas", (0.9, 0.99))),
                      "weight_decay": float(conf.pop("weight_decay", 0.0))}
    raise ValueError(f"unknown optimizer {key!r}; known: {sorted(OPTIMIZERS)}")


OPTIMIZERS = ("adam", "adamw", "sgd", "adadelta", "adagrad", "rmsprop", "radam", "lamb",
              "adafactor", "lion")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Everything of the update chain but the model it applies to."""

    name: str
    cls: type
    kwargs: Dict[str, object]
    schedule: Schedule
    grad_clip: Optional[float]
    frozen: FrozenSet[str]
    plateau: bool = False  # the schedule is constant; the trainer sets the scale
    grad_noise: bool = False  # optax.add_noise(eta=0.01, gamma=0.55) after the clip

    def init(self, model: nn.Module) -> torch.optim.Optimizer:
        """Freeze the ``frozen`` parameters and build the torch optimizer
        over the others, with the learning rate of the first update."""
        params = []
        for name, p in model.named_parameters():
            if name in self.frozen:
                p.requires_grad_(False)
            else:
                params.append(p)
        return self.cls(params, lr=self.schedule(0), **self.kwargs)

    def set_lr(self, optimizer: torch.optim.Optimizer, step: int, plateau_scale: float = 1.0):
        """The schedule's rate for update ``step``; the plateau scale goes
        after an optax optimizer's update, into a torch Adam's lr (the
        same product: Adam's step is linear in lr)."""
        lr = self.schedule(step)
        for group in optimizer.param_groups:
            if "plateau_scale" in group:
                group["lr"], group["plateau_scale"] = lr, plateau_scale
            else:
                group["lr"] = lr * plateau_scale

    def add_noise(self, grads: List[torch.Tensor], step: int):
        """optax.add_noise(eta=0.01, gamma=0.55): N(0, eta / (step+1)^gamma)
        added in place.  The draws come from a generator seeded by the
        update count alone (JAX's chain takes key 0), so a resumed run draws
        what an uninterrupted one does; their bits cannot match JAX's PRNG."""
        if not grads:
            return
        std = math.sqrt(0.01 / (step + 1) ** 0.55)
        seed = int(np.random.SeedSequence([0, step]).generate_state(1)[0])
        gen = torch.Generator(device=grads[0].device).manual_seed(seed)
        for g in grads:
            g.add_(torch.randn(g.shape, generator=gen, device=g.device, dtype=g.dtype), alpha=std)


def build_optimizer(name: str = "adam", conf: Optional[dict] = None,
                    scheduler: Optional[str] = None, scheduler_conf: Optional[dict] = None,
                    grad_clip: Optional[float] = 5.0,
                    freeze_mask: Iterable[str] = (), grad_noise: bool = False) -> OptimizerSpec:
    """The update chain: [frozen out] -> clip by global norm ``grad_clip``
    -> [gradient noise] -> optimizer(schedule) -> [plateau scale].
    ``conf`` takes lr and the optimizer's own options (the JAX registry's
    names and defaults); an unknown option raises.  A plateau scheduler
    (reducelronplateau) keeps the lr constant; the trainer's
    PlateauController sets the scale."""
    conf = dict(conf or {})
    lr = float(conf.pop("lr", 1e-3))
    key = name.lower()
    cls, kwargs = _optimizer_class_and_kwargs(key, conf)
    if conf:
        raise ValueError(f"build_optimizer: unknown options {sorted(conf)} for {key}")
    plateau = (scheduler or "").lower() in PLATEAU_SCHEDULERS
    schedule = build_schedule(None if plateau else scheduler, lr,
                              None if plateau else scheduler_conf)
    if cls is torch.optim.Adam:
        kwargs.pop("weight_decay")
    return OptimizerSpec(key, cls, kwargs, schedule, grad_clip, frozenset(freeze_mask),
                         plateau=plateau, grad_noise=grad_noise)
