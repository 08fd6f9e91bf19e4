"""The precision contract of the flash-attention backward kernels
(llm_guided_asr_tpu_torch/csrc/flash_attention.cu): all five products (S =
Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) run on TF32 tensor
cores with the 3xTF32 split, each float32 operand x taken as big = tf32(x)
and small = tf32(x - big) and the product as small.big + big.small +
big.big.  The CUDA kernels run only on the card; here the same arithmetic is
emulated in torch on the CPU (TF32 rounding as cvt.rna.tf32.f32 does it) and
held against the library's TPU flash attention VJP in interpret mode, at the
float32 gradient tolerance of the card checks.  The same computation with
plain TF32 products (big.big only) misses it by far more, which is why every
product takes the split."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu_torch.ops import flash_attention as tfa
from test_torch_flash import _lengths_mask, library_flash, tpu_branch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero: add half a unit of the 13 dropped bits to the bit pattern,
    then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b on TF32 operands: the 3xTF32 split, or plain TF32 (big.big)."""
    a_big, b_big = tf32(a), tf32(b)
    if not split:
        return a_big @ b_big
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def flash_bwd_tf32(q, k, v, valid, dout, sm_scale: float, split: bool):
    """(dq, dk, dv) as the kernels compute them: the forward's lse (float32,
    CUDA cores), delta = rowsum(out * dout), the scores recomputed, every
    product through :func:`tf32_matmul`, masked pairs exactly 0."""
    out, lse = tfa.flash_attention_fwd(q, k, v, valid, sm_scale)
    delta = (out * dout).sum(-1, keepdim=True)
    pair = valid.bool()[:, None, :, None] & valid.bool()[:, None, None, :]
    s = tf32_matmul(q, k.transpose(-1, -2), split)
    p = torch.where(pair, torch.exp(s * sm_scale - lse[..., None]), 0.0)
    dp = tf32_matmul(dout, v.transpose(-1, -2), split)
    ds = torch.where(pair, p * (dp - delta) * sm_scale, 0.0)
    dv = tf32_matmul(p.transpose(-1, -2), dout, split)
    dk = tf32_matmul(ds.transpose(-1, -2), q, split)
    dq = tf32_matmul(ds, k, split)
    return dq, dk, dv


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1.0
    # ties (1 + ulp/2, 1 + 3 ulp/2) go away from zero, not to even
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, -(1.0 + ulp / 2),
                      1.0 + 1.5 * ulp])
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp])
    torch.testing.assert_close(tf32(x), want, rtol=0, atol=0)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    big = tf32(y)
    assert torch.all(big.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((y - big).abs() <= big.abs() * 2.0 ** -11)


@pytest.mark.parametrize("qk_scale", [1.0, 3.0])
def test_3xtf32_flash_backward_matches_the_library_kernel(qk_scale):
    """[1, 2, 256, 64] with 55 pad frames, q and k at unit and 3x scale (a
    sharper softmax): the 3xTF32 gradients within 1e-4 of the largest
    library gradient, as on the card; plain TF32 more than 10x further off."""
    t, dk, lengths = 256, 64, [201]
    rng = np.random.default_rng(int(10 * qk_scale))
    q, k = ((rng.standard_normal((1, 2, t, dk)) * qk_scale).astype(np.float32)
            for _ in range(2))
    v, g = (rng.standard_normal((1, 2, t, dk)).astype(np.float32) for _ in range(2))
    valid = _lengths_mask(t, lengths)
    sm = 1.0 / math.sqrt(dk)

    def vjp(q, k, v, g):
        _, pull = jax.vjp(lambda *a: library_flash(*a, jnp.asarray(valid), sm), q, k, v)
        return pull(g)

    with tpu_branch():
        j_grads = jax.jit(vjp)(*map(jnp.asarray, (q, k, v, g)))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tvalid = torch.from_numpy(valid.astype(np.int32))
    three = flash_bwd_tf32(*args, tvalid, torch.from_numpy(g), sm, split=True)
    one = flash_bwd_tf32(*args, tvalid, torch.from_numpy(g), sm, split=False)
    for name, g3, g1, jg in zip(("dq", "dk", "dv"), three, one, j_grads):
        ref = np.asarray(jg)
        err3 = np.abs(g3.numpy() - ref).max()
        err1 = np.abs(g1.numpy() - ref).max()
        assert err3 <= 1e-4 * np.abs(ref).max(), (name, err3, np.abs(ref).max())
        assert err1 > 10 * err3, (name, err1, err3)
