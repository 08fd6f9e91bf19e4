"""Port vs JAX, the whole optimizer registry: every optimizer and schedule
of llm_guided_asr_tpu/train/optim.py, with and without the global-norm
clip and with a frozen leaf, the plateau scale and its controller, and the
gradient noise's variance.  The same seeded gradients go through optax's
chain and the port's update on the same three leaves; one is 128 x 160,
so that adafactor factors its second moment."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

SHAPES = {"a": (128, 160), "b": (7, 5), "c": (11,)}
STEPS = 5
# each optimizer's options beyond lr: every branch the JAX wrappers take
CONF = {
    "adam": {},
    "adamw": {"weight_decay": 0.05},
    "sgd": {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01},
    "adadelta": {"weight_decay": 0.01},
    "adagrad": {},
    "rmsprop": {"momentum": 0.9},
    "radam": {},
    "lamb": {"weight_decay": 0.01},
    "adafactor": {},
    "lion": {"weight_decay": 0.01},
}
# radam rectifies from its 6th update on (rho_t >= 5): 8 updates reach it
N_STEPS = {"radam": 8}
# float32: the order of the sums and of the scalar factors; the updates are
# <= lr in size, the parameters ~0.5
RTOL, ATOL = 1e-5, 1e-6


class Leaves(torch.nn.Module):
    def __init__(self, values):
        super().__init__()
        for k, v in values.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}


def _grads(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * rng.uniform(0.1, 1.0)).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(n)]


def _run_jax(name, conf, scheduler, scheduler_conf, clip, frozen, grads, values):
    params = {k: jnp.asarray(v) for k, v in values.items()}
    mask = joptim.path_prefix_mask(params, frozen) if frozen else None
    tx = joptim.build_optimizer(name, dict(conf), scheduler=scheduler,
                                scheduler_conf=scheduler_conf, grad_clip=clip, freeze_mask=mask)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


def _run_port(name, conf, scheduler, scheduler_conf, clip, frozen, grads, values):
    model = Leaves(values)
    spec = toptim.build_optimizer(name, dict(conf), scheduler=scheduler,
                                  scheduler_conf=scheduler_conf, grad_clip=clip,
                                  freeze_mask=toptim.path_prefix_mask(model, frozen))
    state = ttrainer.init_train_state(model, spec)
    for g in grads:
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k]) if p.requires_grad else None
        assert ttrainer.apply_update(state)
    assert state.step == len(grads)
    return {k: p.detach().numpy() for k, p in model.named_parameters()}


def _assert_match(name, conf, scheduler=None, scheduler_conf=None, clip=5.0, frozen=()):
    values = _values()
    grads = _grads(N_STEPS.get(name, STEPS))
    want = _run_jax(name, conf, scheduler, scheduler_conf, clip, frozen, grads, values)
    got = _run_port(name, conf, scheduler, scheduler_conf, clip, frozen, grads, values)
    for k in SHAPES:
        if k in frozen:
            np.testing.assert_array_equal(got[k], values[k])
        assert not np.allclose(got[k], values[k]) or k in frozen, k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("variant", ["clip", "no_clip", "frozen"])
@pytest.mark.parametrize("name", sorted(CONF))
def test_optimizer_matches_optax(name, variant):
    """Five updates (radam eight) with warmuplr over 3 steps; the clip at 5
    binds (the gradients' norm is ~50); 'frozen' freezes leaf b."""
    lr = 1.0 if name == "adadelta" else 1e-2
    _assert_match(name, {"lr": lr, **CONF[name]}, scheduler="warmuplr",
                  scheduler_conf={"warmup_steps": 3},
                  clip=None if variant == "no_clip" else 5.0,
                  frozen=("b",) if variant == "frozen" else ())


SCHEDULES = {
    "warmuplr": {"warmup_steps": 4},
    "noamlr": {"model_size": 64, "warmup_steps": 4},
    "none": {},
    "constant": {},
    "exponentiallr": {"decay_rate": 0.5, "decay_steps": 3},
}


@pytest.mark.parametrize("scheduler", sorted(SCHEDULES))
def test_schedule_matches_optax(scheduler):
    """The schedule's value at updates 0..99 (float32 in JAX: rtol 1e-6),
    then five sgd updates driven by it."""
    j = joptim.build_schedule(scheduler, 0.1, SCHEDULES[scheduler])
    t = toptim.build_schedule(scheduler, 0.1, SCHEDULES[scheduler])
    want = [float(j(jnp.asarray(s, jnp.int32))) for s in range(100)]
    np.testing.assert_allclose([t(s) for s in range(100)], want, rtol=1e-6)
    _assert_match("sgd", {"lr": 0.1}, scheduler=scheduler, scheduler_conf=SCHEDULES[scheduler])


def test_unknown_names_and_options_raise():
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.build_optimizer("adamax")
    with pytest.raises(ValueError, match="unknown scheduler"):
        toptim.build_schedule("cosine", 1e-3)
    with pytest.raises(ValueError, match="unknown options"):
        toptim.build_optimizer("sgd", {"lr": 1e-3, "betas": (0.9, 0.99)})


def test_plateau_scale_multiplies_the_update_as_optax_scale():
    """tests/test_trainer_guards.py's case on both packages: sgd lr 1, one
    update at scale 1, one at 0.5, with rmsprop's momentum too (the scale
    comes after the trace, not inside it)."""
    for name, conf in (("sgd", {"lr": 1.0}), ("rmsprop", {"lr": 0.1, "momentum": 0.9}),
                       ("adam", {"lr": 1e-2})):
        values, grads = _values(), _grads(3)
        params = {k: jnp.asarray(v) for k, v in values.items()}
        tx = joptim.build_optimizer(name, dict(conf), scheduler="reducelronplateau",
                                    scheduler_conf={"factor": 0.5, "patience": 1},
                                    grad_clip=None)
        opt = tx.init(params)
        model = Leaves(values)
        spec = toptim.build_optimizer(name, dict(conf), scheduler="reducelronplateau",
                                      scheduler_conf={"factor": 0.5, "patience": 1},
                                      grad_clip=None)
        assert spec.plateau
        state = ttrainer.init_train_state(model, spec)
        for g, scale in zip(grads, (1.0, 0.5, 0.25)):
            opt = joptim.set_plateau_scale(opt, scale)
            updates, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, params)
            params = optax.apply_updates(params, updates)
            state.plateau_scale = scale
            for k, p in model.named_parameters():
                p.grad = torch.from_numpy(g[k])
            ttrainer.apply_update(state)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", sorted(CONF))
def test_an_update_leaves_the_gradients_as_they_were(name):
    """The update reads the gradients and writes nothing into them, as
    optax's functional update does.  SGD without momentum or decay once
    scaled them by -lr in place; in this file's tests the gradients are
    numpy arrays that JAX, dispatching asynchronously, may still be reading
    (on the CPU ``jnp.asarray`` aliases the buffer), so the JAX side of a
    comparison could see -lr * g under load."""
    for conf in (dict(CONF[name]), {}):
        values, (g,) = _values(), _grads(1)
        want = {k: v.copy() for k, v in g.items()}
        model = Leaves(values)
        state = ttrainer.init_train_state(model, toptim.build_optimizer(
            name, {"lr": 0.5, **conf}, grad_clip=None))
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k])
        assert ttrainer.apply_update(state)
        for k in g:
            np.testing.assert_array_equal(g[k], want[k], err_msg=f"{name} {conf} {k}")


def test_plateau_controller_and_replay_match_jax():
    history = list(np.random.default_rng(3).uniform(0.5, 2.0, 20)) + [0.4] * 6
    for conf in ({"factor": 0.5, "patience": 1}, {"factor": 0.1, "patience": 0,
                                                  "threshold": 0.05, "mode": "max"}):
        j, t = joptim.PlateauController(**conf), toptim.PlateauController(**conf)
        assert [t.step(v) for v in history] == [j.step(v) for v in history]
        assert toptim.PlateauController(**conf).replay(history) == \
            joptim.PlateauController(**conf).replay(history) == t.scale


def test_grad_noise_variance_follows_the_annealing():
    """optax.add_noise(eta=0.01, gamma=0.55): with zero gradients and sgd at
    lr 1, each update is the noise alone; its variance over 256 x 256
    values is eta / (1 + step)^gamma within 4 % (~7 standard errors) in
    both packages; the port's draws depend on (seed, step) only."""
    shape = (256, 256)
    model = Leaves({"w": np.zeros(shape, np.float32)})
    spec = toptim.build_optimizer("sgd", {"lr": 1.0}, grad_clip=None, grad_noise=True)
    state = ttrainer.init_train_state(model, spec)
    params = {"w": jnp.zeros(shape)}
    tx = joptim.build_optimizer("sgd", {"lr": 1.0}, grad_clip=None, grad_noise=True)
    opt = tx.init(params)
    snapshots = []
    for step in range(4):
        before = model.w.detach().clone()
        model.w.grad = torch.zeros(shape)
        ttrainer.apply_update(state)
        delta = (model.w.detach() - before).numpy()
        snapshots.append((before, model.w.detach().clone()))
        updates, opt = tx.update({"w": jnp.zeros(shape)}, opt, params)
        want = 0.01 / (1 + step) ** 0.55
        for got in (float(np.var(delta)), float(np.var(np.asarray(updates["w"])))):
            assert abs(got / want - 1) < 0.04, (step, got, want)
    again = toptim.build_optimizer("sgd", {"lr": 1.0}, grad_clip=None, grad_noise=True)
    model2 = Leaves({"w": snapshots[2][0].numpy()})
    state2 = ttrainer.init_train_state(model2, again)
    state2.step = 2
    model2.w.grad = torch.zeros(shape)
    ttrainer.apply_update(state2)
    assert torch.equal(model2.w.detach(), snapshots[2][1])


def test_skipped_update_leaves_the_schedule_count():
    """A non-finite gradient skips the update: the count that drives the
    schedule and the optax optimizers' bias corrections stays."""
    model = Leaves(_values())
    state = ttrainer.init_train_state(model, toptim.build_optimizer("radam", {"lr": 1e-2}))
    g = _grads(1)[0]
    for k, p in model.named_parameters():
        p.grad = torch.from_numpy(g[k])
    assert ttrainer.apply_update(state) and state.step == 1
    model.c.grad = torch.full((11,), float("nan"))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    assert not ttrainer.apply_update(state)
    assert state.step == 1 and all(s["count"] == 1 for s in state.optimizer.state.values())
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
