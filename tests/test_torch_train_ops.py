"""Port vs JAX: the training ops — masked batch norm, SpecAug, losses and
learning-rate schedules — on the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models.conformer import MaskedBatchNorm as JMaskedBatchNorm
from llm_guided_asr_tpu.ops import losses as jlosses
from llm_guided_asr_tpu.ops import specaug as jspec
from llm_guided_asr_tpu.ops.masked_bn import masked_batch_norm as j_masked_bn
from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu_torch.models.conformer import MaskedBatchNorm
from llm_guided_asr_tpu_torch.ops import losses as tlosses
from llm_guided_asr_tpu_torch.ops import specaug as tspec
from llm_guided_asr_tpu_torch.ops.masked_bn import masked_batch_norm
from llm_guided_asr_tpu_torch.train import optim as toptim
from test_torch_train import jit

torch.set_num_threads(1)

T = torch.from_numpy


def _bn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 11, 6)) * 2.0 + 0.5).astype(np.float32)
    valid = np.arange(11)[None] < np.array([[11], [7], [2]])
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    dy = rng.standard_normal((3, 11, 6)).astype(np.float32)
    return x, valid, scale, bias, dy


def test_masked_batch_norm_forward_and_grads_match_jax():
    x, valid, scale, bias, dy = _bn_inputs()
    (jy, jmean, jvar), j_vjp = jax.vjp(lambda a, s, b: j_masked_bn(a, jnp.asarray(valid), s, b),
                                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    j_dx, j_ds, j_db = j_vjp((jnp.asarray(dy), jnp.zeros(6), jnp.zeros(6)))
    leaves = [T(a).requires_grad_(True) for a in (x, scale, bias)]
    y, mean, var = masked_batch_norm(leaves[0], T(valid), leaves[1], leaves[2])
    assert not mean.requires_grad and not var.requires_grad
    grads = torch.autograd.grad(y, leaves, T(dy))
    for got, want in ((y, jy), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)
    for got, want in zip(grads, (j_dx, j_ds, j_db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def test_masked_batch_norm_module_running_stats_match_jax():
    """Two training calls then an eval call: momentum 0.9 with the biased
    variance, as the flax module updates its batch_stats."""
    x, valid, scale, bias, _ = _bn_inputs(1)
    jmod = JMaskedBatchNorm()
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(valid))
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    tmod = MaskedBatchNorm(6)
    with torch.no_grad():
        tmod.weight.copy_(T(scale))
        tmod.bias.copy_(T(bias))
    tmod.train()
    for step in range(2):
        xs = x * (1.0 + step)
        jy, upd = jmod.apply(variables, jnp.asarray(xs), jnp.asarray(valid),
                             use_running_average=False, mutable=["batch_stats"])
        variables = {**variables, **upd}
        ty = tmod(T(xs), T(valid))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)
    tmod.eval()
    jy = jmod.apply(variables, jnp.asarray(x), jnp.asarray(valid), use_running_average=True)
    np.testing.assert_allclose(tmod(T(x), T(valid)).detach().numpy(), np.asarray(jy),
                               rtol=2e-4, atol=2e-5)


def _feats(seed=2):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 40, 12)).astype(np.float32)
    lengths = np.array([40, 31, 17], np.int32)
    return feats, lengths


def test_time_warp_matches_jax_given_the_same_samples():
    feats, lengths = _feats()
    key = jax.random.PRNGKey(3)
    window = 5
    # the values jspec.time_warp draws from this key
    k1, k2 = jax.random.split(key)
    lens = jnp.asarray(lengths, jnp.float32)
    hi = jnp.maximum(lens - window, window + 1.0)
    center = window + jax.random.uniform(k1, (3,)) * (hi - window)
    shift = jax.random.uniform(k2, (3,), minval=-float(window), maxval=float(window))
    want = jspec.time_warp(key, jnp.asarray(feats), jnp.asarray(lengths), window)
    got = tspec.time_warp(T(feats), T(lengths), T(np.array(center)), T(np.array(shift)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [1, 2])
def test_masks_match_jax_given_the_same_samples(axis):
    feats, _ = _feats(4)
    key = jax.random.PRNGKey(5 + axis)
    axis_len = feats.shape[axis]
    widths = np.array([[3, 0], [7, 2], [axis_len, 1]], np.int32)
    u = jax.random.uniform(key, widths.shape)  # the starts jspec._mask_along_axis draws
    starts = np.array((u * (axis_len - widths + 1).astype(np.float32)).astype(jnp.int32))
    want = jspec._mask_along_axis(key, jnp.asarray(feats), jnp.asarray(widths), axis_len, axis, 2)
    got = tspec.mask_along_axis(T(feats), T(starts).long(), T(widths).long(), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_specaug_draws_from_its_generator():
    feats, lengths = _feats(6)
    cfg = tspec.SpecAugConfig(time_mask_width_range=(0, 5))
    run = lambda seed: tspec.specaug(torch.Generator().manual_seed(seed), T(feats),  # noqa: E731
                                     T(lengths).long(), cfg)
    a, b, c = run(0), run(0), run(1)
    assert a.shape == feats.shape and torch.equal(a, b) and not torch.equal(a, c)
    # frames past each length are left as they were by the warp and masked only as zeros
    tail = T(feats)[2, 17:]
    assert torch.all((a[2, 17:] == tail) | (a[2, 17:] == 0))


def _ctc_inputs():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 12, 6)).astype(np.float32)
    logit_lengths = np.array([12, 10, 3], np.int32)
    labels = np.array([[1, 2, 2, 3, -1], [4, 5, 1, -1, -1], [1, 2, 3, 4, 5]], np.int32)
    label_lengths = np.array([4, 3, 5], np.int32)  # the third needs >= 5 frames: infeasible
    return logits, logit_lengths, labels, label_lengths


def test_ctc_loss_and_gradient_match_jax():
    logits, ll, labels, lab_l = _ctc_inputs()
    # jitted: eager JAX compiles each op of the CTC scans on its own
    j_loss, j_grad = jit(jax.value_and_grad(jlosses.ctc_loss))(
        jnp.asarray(logits), jnp.asarray(ll), jnp.asarray(labels), jnp.asarray(lab_l))
    j_per = jit(jlosses.ctc_loss_per_example)(jnp.asarray(logits), jnp.asarray(ll),
                                                  jnp.asarray(labels), jnp.asarray(lab_l))
    lt = T(logits).requires_grad_(True)
    t_loss = tlosses.ctc_loss(lt, T(ll), T(labels), T(lab_l))
    (t_grad,) = torch.autograd.grad(t_loss, lt)
    t_per = tlosses.ctc_loss_per_example(T(logits), T(ll), T(labels), T(lab_l))
    assert float(t_per[2]) == 0.0 and float(j_per[2]) == 0.0
    np.testing.assert_allclose(t_per.numpy(), np.asarray(j_per), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-4)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-4, atol=1e-5)
    assert np.all(t_grad.numpy()[2] == 0.0)  # the infeasible example takes no gradient
    # the Bayes-risk CTC (brctc) is ported: its loss and gradient match too
    j_loss, j_grad = jit(jax.value_and_grad(functools.partial(jlosses.ctc_loss,
                                                                  time_risk=0.5)))(
        jnp.asarray(logits), jnp.asarray(ll), jnp.asarray(labels), jnp.asarray(lab_l))
    lt = T(logits).requires_grad_(True)
    t_loss = tlosses.ctc_loss(lt, T(ll), T(labels), T(lab_l), time_risk=0.5)
    (t_grad,) = torch.autograd.grad(t_loss, lt)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-4)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss_matches_jax(smoothing, normalize_length):
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 5, 9)).astype(np.float32)
    targets = np.array([[1, 4, 8, 0, -1], [2, 2, -1, -1, -1]], np.int32)
    j_loss, j_grad = jax.value_and_grad(jlosses.label_smoothing_loss)(
        jnp.asarray(logits), jnp.asarray(targets), smoothing, -1, normalize_length)
    lt = T(logits).requires_grad_(True)
    t_loss = tlosses.label_smoothing_loss(lt, T(targets), smoothing, -1, normalize_length)
    (t_grad,) = torch.autograd.grad(t_loss, lt)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(t_grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-6)


def test_add_sos_eos_and_accuracy_match_jax():
    text = np.array([[3, 4, 5, -1], [6, -1, -1, -1], [1, 2, 3, 4]], np.int32)
    lens = np.array([3, 1, 4], np.int32)
    j_in, j_out = jlosses.add_sos_eos(jnp.asarray(text), jnp.asarray(lens), 9, 9, -1)
    t_in, t_out = tlosses.add_sos_eos(T(text), T(lens), 9, 9, -1)
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    logits = np.random.default_rng(9).standard_normal((3, 5, 10)).astype(np.float32)
    logits[0, 0, 3] = 10.0  # one sure hit
    np.testing.assert_allclose(float(tlosses.accuracy(T(logits), t_out)),
                               float(jlosses.accuracy(jnp.asarray(logits), j_out)), rtol=1e-6)


@pytest.mark.parametrize("name,conf", [("warmuplr", {"warmup_steps": 3}),
                                       ("noamlr", {"model_size": 256, "warmup_steps": 4}),
                                       ("none", {})])
def test_schedules_match_jax(name, conf):
    j_sched = joptim.build_schedule(name, 2e-3, conf)
    t_sched = toptim.build_schedule(name, 2e-3, conf)
    for step in range(6):
        np.testing.assert_allclose(t_sched(step), float(j_sched(jnp.asarray(step))), rtol=1e-6)


def test_path_prefix_mask_names_whole_components():
    mod = torch.nn.ModuleDict({"encoder": torch.nn.Linear(2, 2), "encoder2": torch.nn.Linear(2, 2),
                               "llm": torch.nn.ModuleDict({"a": torch.nn.Linear(2, 2)})})
    assert toptim.path_prefix_mask(mod, ["encoder", "llm/a"]) == {
        "encoder.weight", "encoder.bias", "llm.a.weight", "llm.a.bias"}
    # every optimizer of the JAX registry is ported; a name outside it raises
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.build_optimizer("adamax")
