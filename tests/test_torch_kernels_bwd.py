"""Port kernels' training paths vs the JAX package: the dropout hash, and
the plain forward and gradients of rel-pos attention and the depthwise
conv (the CUDA kernels against the plain versions are in
tests/test_torch_gpu.py).

The rel-pos attention reference is the JAX Pallas kernel run in interpret
mode on the CPU, through its custom VJP, as
tests/test_rel_attention_kernel.py runs it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.ops.depthwise_conv import depthwise_conv1d as j_dwconv
from llm_guided_asr_tpu.ops.rel_attention import (
    _fwd_call as j_fwd_call,
    dropout_keep_mask as j_keep_mask,
    rel_attention_pad_pos,
    rel_flash_attention,
)
from llm_guided_asr_tpu_torch.ops import depthwise_conv as tdw
from llm_guided_asr_tpu_torch.ops import rel_attention as tra

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 7, 12345, -1, -2**31, 2**31 - 1, -987654321])
def test_dropout_keep_mask_is_bit_equal_to_jax(seed):
    for hi, bi, rate in ((0, 0, 0.1), (3, 5, 0.3), (1, 63, 0.5), (2, 17, 0.2)):
        want = np.asarray(j_keep_mask(jnp.int32(seed), hi, bi, (37, 53), rate))
        got = tra.dropout_keep_mask(seed, hi, bi, 37, 53, rate).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"head {hi} batch {bi} rate {rate}")


def test_dropout_keep_mask_broadcasts_heads_and_batches():
    got = tra.dropout_keep_mask(99, torch.arange(3)[None, :], torch.arange(2)[:, None], 8, 9, 0.4)
    assert got.shape == (2, 3, 8, 9)
    for b in range(2):
        for h in range(3):
            np.testing.assert_array_equal(
                got[b, h].numpy(), np.asarray(j_keep_mask(jnp.int32(99), h, b, (8, 9), 0.4)))


def _rel_inputs(b, h, t, dk, lengths, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    qu, qv, k, v, dout = (mk(b, h, t, dk) for _ in range(5))
    p_dense = mk(2 * t - 1, h, dk)  # [2T-1, H, dk], the flax module's layout
    kv_valid = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return qu, qv, k, v, p_dense, kv_valid, dout


@pytest.mark.parametrize("rate,tol", [(0.0, 3e-4), (0.2, 5e-4)])
@pytest.mark.parametrize("t,lengths,seed", [(40, [40, 33], 0), (77, [77, 50], 1)])
def test_rel_attention_plain_grads_match_jax_kernel(rate, tol, t, lengths, seed):
    b, h, dk = 2, 2, 64
    qu, qv, k, v, p_dense, kv_valid, dout = _rel_inputs(b, h, t, dk, lengths, seed)
    sm, drop_seed = 1.0 / math.sqrt(dk), 12345 + seed
    tp = -(-t // 128) * 128
    pad = ((0, 0), (0, 0), (0, tp - t), (0, 0))
    jpad = lambda x: jnp.pad(jnp.asarray(x), pad)  # noqa: E731
    j_valid = jnp.pad(jnp.asarray(kv_valid), ((0, 0), (0, tp - t)))

    def j_fn(qu_, qv_, k_, v_, p_):
        return rel_flash_attention(qu_, qv_, k_, v_, p_, j_valid, sm,
                                   seed=jnp.int32(drop_seed), dropout_rate=rate)

    j_out, j_vjp = jax.vjp(j_fn, jpad(qu), jpad(qv), jpad(k), jpad(v),
                           rel_attention_pad_pos(jnp.asarray(p_dense), t, tp))
    j_grads = [np.asarray(g) for g in j_vjp(jpad(dout))]  # zero cotangent on padded rows

    T = torch.from_numpy
    leaves = [T(x).requires_grad_(True) for x in (qu, qv, k, v)]
    leaves.append(T(np.moveaxis(p_dense, 1, 0).copy()).requires_grad_(True))
    t_out = tra.rel_attention(*leaves, T(kv_valid), sm, seed=drop_seed, dropout_rate=rate)
    t_grads = torch.autograd.grad(t_out, leaves, T(dout))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out)[:, :, :t],
                               rtol=tol, atol=tol)
    for name, tg, jg in zip(("dqu", "dqv", "dk", "dv"), t_grads, j_grads):
        np.testing.assert_allclose(tg.numpy(), jg[:, :, :t], rtol=tol, atol=tol, err_msg=name)
    # dp: the kernel's padded table holds the 2T-1 real rows at offset Tp - T
    off = tp - t
    np.testing.assert_allclose(t_grads[4].numpy(), j_grads[4][:, off:off + 2 * t - 1],
                               rtol=tol, atol=tol, err_msg="dp")
    outside = np.concatenate([j_grads[4][:, :off].ravel(), j_grads[4][:, off + 2 * t - 1:].ravel()])
    np.testing.assert_allclose(outside, 0.0, atol=tol)


def test_saved_log_sum_exp_matches_the_jax_kernels_statistics():
    """rel_attention_fwd's lse = m + log(l) of the TPU kernel's forward: the
    pre-dropout softmax statistics the backward recomputes from."""
    t, lengths = 40, [40, 29]
    qu, qv, k, v, p_dense, kv_valid, _ = _rel_inputs(2, 2, t, 64, lengths, 5)
    tp = 128
    pad = lambda x: jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, tp - t), (0, 0)))  # noqa: E731
    _, j_l, j_m = j_fwd_call(pad(qu), pad(qv), pad(k), pad(v),
                             rel_attention_pad_pos(jnp.asarray(p_dense), t, tp),
                             jnp.pad(jnp.asarray(kv_valid), ((0, 0), (0, tp - t))),
                             jnp.int32(3), 0.125, 0.3)
    want = (np.asarray(j_m) + np.log(np.asarray(j_l)))[:, :, :t, 0]
    T = torch.from_numpy
    out, lse = tra.rel_attention_fwd(T(qu), T(qv), T(k), T(v),
                                     T(np.moveaxis(p_dense, 1, 0).copy()), T(kv_valid), 0.125,
                                     seed=3, dropout_rate=0.3)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, t)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out, tra.rel_attention(T(qu), T(qv), T(k), T(v),
                                                      T(np.moveaxis(p_dense, 1, 0).copy()),
                                                      T(kv_valid), 0.125, 3, 0.3))


def test_rel_attention_bwd_wrapper_on_cpu_is_the_plain_backward():
    qu, qv, k, v, p_dense, kv_valid, dout = _rel_inputs(2, 3, 11, 8, [11, 6], 4)
    T = torch.from_numpy
    p = T(np.moveaxis(p_dense, 1, 0).copy())
    args = [T(x) for x in (qu, qv, k, v)] + [p]
    before = {**tra.KERNEL.launches, **tdw.KERNEL.launches}
    got = tra.rel_attention_bwd(*args, T(kv_valid), None, None, T(dout), 0.3, seed=5,
                                dropout_rate=0.25)
    leaves = [x.clone().requires_grad_(True) for x in args]
    want = torch.autograd.grad(tra.rel_attention_plain(*leaves, T(kv_valid), 0.3, 5, 0.25),
                               leaves, T(dout))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert {**tra.KERNEL.launches, **tdw.KERNEL.launches} == before


@pytest.mark.parametrize("k_size", [7, 8, 31])
def test_depthwise_conv_plain_grads_match_jax(k_size):
    rng = np.random.default_rng(10 + k_size)
    x = rng.standard_normal((2, 45, 24)).astype(np.float32)
    w = rng.standard_normal((k_size, 24)).astype(np.float32)
    dy = rng.standard_normal((2, 45, 24)).astype(np.float32)
    _, j_vjp = jax.vjp(j_dwconv, jnp.asarray(x), jnp.asarray(w))
    j_dx, j_dw = j_vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    t_dx, t_dw = torch.autograd.grad(tdw.depthwise_conv1d(xt, wt), (xt, wt), torch.from_numpy(dy))
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_dw.numpy(), np.asarray(j_dw), rtol=1e-5, atol=1e-4)


def test_cpu_backward_calls_launch_nothing():
    before = {**tra.KERNEL.launches, **tdw.KERNEL.launches}
    qu, qv, k, v, p_dense, kv_valid, dout = _rel_inputs(1, 2, 10, 8, [10], 3)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (qu, qv, k, v)]
    leaves.append(torch.from_numpy(np.moveaxis(p_dense, 1, 0).copy()).requires_grad_(True))
    out = tra.rel_attention(*leaves, torch.from_numpy(kv_valid), 0.3, seed=1, dropout_rate=0.1)
    assert type(out.grad_fn).__name__ == "_RelAttentionFnBackward"  # the wrappers, not autograd
    out.backward(torch.from_numpy(dout))
    x = torch.ones(1, 5, 3, requires_grad=True)
    w = torch.ones(3, 3, requires_grad=True)
    tdw.depthwise_conv1d(x, w).sum().backward()
    tdw.depthwise_conv1d_bwd(x.detach(), w.detach(), torch.ones(1, 5, 3))
    assert {**tra.KERNEL.launches, **tdw.KERNEL.launches} == before
    assert all(leaf.grad is not None for leaf in leaves) and w.grad is not None


def test_training_wrappers_reject_bad_operands():
    x = torch.zeros(1, 2, 10, 8)
    p = torch.zeros(2, 19, 8)
    valid = torch.ones(1, 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="seed"):
        tra.rel_attention(x, x, x, x, p, valid, 1.0, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        tra.rel_attention(x, x, x, x, p, valid, 1.0, seed=1, dropout_rate=1.0)
    with pytest.raises(ValueError, match="dy"):
        tdw.depthwise_conv1d_bwd(torch.zeros(1, 5, 4), torch.zeros(3, 4), torch.zeros(1, 6, 4))
