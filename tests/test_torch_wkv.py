"""Port vs JAX, the WKV recurrence: the plain loop against the JAX scan and
the TPU kernel body (wkv_pallas in interpret mode), the state chaining,
large |k| through the running maximum, and the gradients of the
differentiable ``wkv`` against jax.grad of the JAX custom VJP.  The CUDA
kernels themselves are held against the plain loop on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.ops import wkv as jwkv
from llm_guided_asr_tpu_torch.ops import wkv as twkv

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)  # float32, the same formula in another framework


def _inputs(seed, b, t, c, k_scale=1.0):
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.standard_normal(c) * 0.5).astype(np.float32)
    u = (rng.standard_normal(c) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, t, c)) * k_scale).astype(np.float32)
    v = rng.standard_normal((b, t, c)).astype(np.float32)
    return w, u, k, v


def _assert_out_close(got, want):
    (y, state), (jy, jstate) = got, want
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name, s, js in zip(("aa", "bb", "pp"), state, jstate):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL, err_msg=name)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """wkv_pallas imports pallas inside the function, so running its TPU
    kernel body in interpret mode on the CPU needs no change to the JAX
    package."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("b,t,c,k_scale", [(2, 9, 16, 1.0), (1, 1, 5, 1.0), (3, 13, 33, 30.0)])
def test_plain_wkv_matches_jax_scan_and_tpu_kernel(interpret_pallas, b, t, c, k_scale):
    w, u, k, v = _inputs(b * t + c, b, t, c, k_scale)
    got = twkv.wkv_fwd(*map(torch.from_numpy, (w, u, k, v)))
    _assert_out_close(got, jwkv.wkv_scan(*map(jnp.asarray, (w, u, k, v))))
    _assert_out_close(got, jwkv.wkv_pallas(*map(jnp.asarray, (w, u, k, v))))
    if k_scale > 1:  # the running maximum took over: no overflow anywhere
        assert np.isfinite(got[0].numpy()).all() and float(got[1][2].max()) > 20


def test_state_chains_across_calls(interpret_pallas):
    w, u, k, v = _inputs(3, 2, 12, 8)
    tw, tu, tk, tv = map(torch.from_numpy, (w, u, k, v))
    y1, st = twkv.wkv_fwd(tw, tu, tk[:, :5], tv[:, :5])
    y2, st2 = twkv.wkv_fwd(tw, tu, tk[:, 5:], tv[:, 5:], st)
    full = twkv.wkv_fwd(tw, tu, tk, tv)
    _assert_out_close((torch.cat([y1, y2], 1), st2), (full[0].numpy(), [s.numpy() for s in full[1]]))
    jw, ju, jk, jv = map(jnp.asarray, (w, u, k, v))
    jst = jwkv.wkv_scan(jw, ju, jk[:, :5], jv[:, :5])[1]
    _assert_out_close((y2, st2), jwkv.wkv_pallas(jw, ju, jk[:, 5:], jv[:, 5:], jst))
    init = twkv.wkv_init_state(2, 8)
    for got, want in zip(init, jwkv.wkv_init_state(2, 8)):  # pp = -1e38, finite in float32
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,t,c,k_scale", [(2, 7, 6, 1.0), (3, 5, 4, 30.0)])
def test_wkv_gradients_match_jax(b, t, c, k_scale):
    w, u, k, v = _inputs(10 + t, b, t, c, k_scale)
    g = np.random.default_rng(5).standard_normal((b, t, c)).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jwkv.wkv(*a) * g), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (w, u, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (w, u, k, v)]
    before = dict(twkv.KERNEL.launches)
    y = twkv.wkv(*leaves)
    y.backward(torch.from_numpy(g))
    assert twkv.KERNEL.launches == before  # the CPU runs the plain versions
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jwkv.wkv(*map(jnp.asarray,
                                                                            (w, u, k, v)))), **TOL)
    for name, leaf, jg in zip("wukv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_wkv_checks_its_inputs():
    w, u, k, v = map(torch.from_numpy, _inputs(0, 1, 3, 4))
    with pytest.raises(ValueError, match="shapes"):
        twkv.wkv(w[:3], u, k, v)
    with pytest.raises(TypeError, match="float32"):
        twkv.wkv(w.double(), u, k, v)
    with pytest.raises(ValueError, match="state"):
        twkv.wkv_fwd(w, u, k, v, twkv.wkv_init_state(2, 4))
    y = twkv.wkv(w, u, k.double(), v.double())
    assert y.dtype == torch.float64  # computed in float32, returned in k's type
