"""Port kernels: the plain versions vs the JAX package (the CUDA kernels
against the plain versions are in tests/test_torch_gpu.py).

The rel-pos attention reference is the JAX Pallas kernel run in interpret
mode on the CPU, as tests/test_rel_attention_kernel.py runs it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.ops.depthwise_conv import depthwise_conv1d as j_dwconv
from llm_guided_asr_tpu.ops.rel_attention import rel_attention_pad_pos, rel_flash_attention
from llm_guided_asr_tpu_torch.ops import depthwise_conv as tdw
from llm_guided_asr_tpu_torch.ops import rel_attention as tra


def _rel_inputs(b, h, t, dk, lengths, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(dtype)
    qu, qv, k, v = (mk(b, h, t, dk) for _ in range(4))
    p_dense = mk(2 * t - 1, h, dk)  # [2T-1, H, dk], the flax module's layout
    kv_valid = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return qu, qv, k, v, p_dense, kv_valid


@pytest.mark.parametrize("t,lengths,seed", [(40, [40, 33], 0), (77, [77, 50], 1)])
def test_rel_attention_plain_matches_jax_kernel(t, lengths, seed):
    b, h, dk = 2, 2, 64
    qu, qv, k, v, p_dense, kv_valid = _rel_inputs(b, h, t, dk, lengths, seed)
    sm = 1.0 / math.sqrt(dk)
    tp = -(-t // 128) * 128
    pad = ((0, 0), (0, 0), (0, tp - t), (0, 0))
    j_out = rel_flash_attention(
        *(jnp.pad(jnp.asarray(x), pad) for x in (qu, qv, k, v)),
        rel_attention_pad_pos(jnp.asarray(p_dense), t, tp),
        jnp.pad(jnp.asarray(kv_valid), ((0, 0), (0, tp - t))), sm,
    )
    T = torch.from_numpy
    t_out = tra.rel_attention(T(qu), T(qv), T(k), T(v), T(np.moveaxis(p_dense, 1, 0).copy()),
                              T(kv_valid), sm)
    for bi, n in enumerate(lengths):  # valid query rows
        np.testing.assert_allclose(t_out.numpy()[bi, :, :n], np.asarray(j_out)[bi, :, :n],
                                   rtol=2e-4, atol=2e-5)


def test_rel_shift_matches_jax():
    from llm_guided_asr_tpu.models.transformer import _rel_shift

    x = np.random.default_rng(5).standard_normal((2, 3, 9, 17)).astype(np.float32)
    np.testing.assert_array_equal(tra.rel_shift(torch.from_numpy(x), 9).numpy(),
                                  np.asarray(_rel_shift(jnp.asarray(x), 9)))


@pytest.mark.parametrize("k_size", [7, 8, 31])
def test_depthwise_conv_plain_matches_jax(k_size):
    rng = np.random.default_rng(k_size)
    x = rng.standard_normal((2, 45, 24)).astype(np.float32)
    w = rng.standard_normal((k_size, 24)).astype(np.float32)
    ref = np.asarray(j_dwconv(jnp.asarray(x), jnp.asarray(w)))
    out = tdw.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cpu_calls_take_the_plain_version_and_launch_nothing():
    before = (tra.KERNEL.launches, tdw.KERNEL.launches)
    qu, qv, k, v, p_dense, kv_valid = _rel_inputs(1, 2, 10, 8, [10], 3)
    T = torch.from_numpy
    tra.rel_attention(T(qu), T(qv), T(k), T(v), T(np.moveaxis(p_dense, 1, 0).copy()),
                      T(kv_valid), 0.3)
    tdw.depthwise_conv1d(torch.ones(1, 5, 3), torch.ones(3, 3))
    assert (tra.KERNEL.launches, tdw.KERNEL.launches) == before


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 2, 10, 8)
    p = torch.zeros(2, 19, 8)
    valid = torch.ones(1, 10, dtype=torch.int32)
    with pytest.raises(ValueError):
        tra.rel_attention(x, x, x, x, torch.zeros(2, 20, 8), valid, 1.0)
    with pytest.raises(TypeError):
        tra.rel_attention(x, x, x, x, p, valid.bool(), 1.0)
    with pytest.raises(TypeError):
        tra.rel_attention(x.double(), x, x, x, p, valid, 1.0)
    with pytest.raises(ValueError):
        tdw.depthwise_conv1d(torch.zeros(1, 5, 4), torch.zeros(3, 5))
    with pytest.raises(TypeError):
        tdw.depthwise_conv1d(torch.zeros(1, 5, 4), torch.zeros(3, 4, dtype=torch.bfloat16))

