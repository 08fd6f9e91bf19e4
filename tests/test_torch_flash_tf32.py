"""The precision contract of the flash-attention kernels
(llm_guided_asr_tpu_torch/csrc/flash_attention.cu): all their products (the
forward's S = Q K^T and O = P V; the backward's S, dP = dO V^T, dV = P^T dO,
dK = dS^T Q, dQ = dS K) run on TF32 tensor cores with the 3xTF32 split, each
float32 operand x taken as big = tf32(x) and small = tf32(x - big) and the
product as small.big + big.small + big.big.  The CUDA kernels run only on
the card; here the same arithmetic is emulated in torch on the CPU (TF32
rounding as cvt.rna.tf32.f32 does it; the forward's online softmax over key
tiles, each tile's P V in a fresh accumulator) and held against the
library's TPU flash attention, forward and VJP, in interpret mode, at the
float32 tolerances of the card checks.  The same computation with plain
TF32 products (big.big only) misses them, which is why every product takes
the split."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu_torch.ops import flash_attention as tfa
from test_torch_flash import _lengths_mask, library_flash, tpu_branch

torch.set_num_threads(1)


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


LOG2E = 1.4426950408889634
STREAM = 32  # keys per streamed tile of the forward kernel at head dim 64


def flash_fwd_tf32(q, k, v, valid, sm_scale: float, split: bool, stream: int = STREAM):
    """(out, lse) as the forward kernel computes them: key tiles of
    ``stream`` frames in order, a tile with no valid key skipped; per tile S
    through :func:`tf32_matmul`, masked keys -inf, the running row max m
    and row sum l in base 2, P = 2^(S scale log2(e) - m), and the tile's
    P V through :func:`tf32_matmul` into a fresh accumulator added to the
    rescaled running output.  Pad query rows 0, lse = ln 2 (m + log2 l)."""
    b, h, t, dk = q.shape
    keys = valid.bool()
    m = torch.full((b, h, t, 1), -math.inf)
    l = torch.zeros(b, h, t, 1)
    acc = torch.zeros(b, h, t, dk)
    for j0 in range(0, t, stream):
        j1 = min(t, j0 + stream)
        tile = keys[:, j0:j1]
        s = tf32_matmul(q, k[:, :, j0:j1].transpose(-1, -2), split) * (sm_scale * LOG2E)
        s = s.masked_fill(~tile[:, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        has = tile.any(dim=1)[:, None, None, None]  # tiles of pads only are skipped
        m_new = torch.where(has, m_new, m)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        part = tf32_matmul(p, v[:, :, j0:j1], split)  # a fresh accumulator per tile
        l = torch.where(has, l * alpha + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(has, acc * alpha + part, acc)
        m = m_new
    rows = keys[:, None, :, None]
    out = torch.where(rows, acc / torch.where(rows, l, 1.0), 0.0)
    lse = torch.where(rows, (m + torch.log2(torch.where(rows, l, 1.0))) / LOG2E, 0.0)
    return out, lse[..., 0]


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


def _fwd_case(t, lengths, qk_scale, seed, h=2, dk=64):
    rng = np.random.default_rng(seed)
    q, k = ((rng.standard_normal((len(lengths), h, t, dk)) * qk_scale).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((len(lengths), h, t, dk)).astype(np.float32)
    return q, k, v, _lengths_mask(t, lengths), 1.0 / math.sqrt(dk)


def _library_fwd(q, k, v, valid, sm):
    with tpu_branch():
        out = jax.jit(lambda *a: library_flash(*a, sm))(*map(jnp.asarray, (q, k, v, valid)))
    return np.asarray(out)


@pytest.mark.parametrize("t,lengths", [
    (200, [200, 137]),    # pads in one batch row; 200 = 6 tiles and 8 frames
    (77, [77, 0, 40]),    # a batch row of pads only; T not a multiple of the tile
    (300, [300]),         # every frame valid, a ragged last tile
])
def test_3xtf32_flash_forward_matches_the_library_kernel(t, lengths):
    """The forward's 3xTF32 output within 2e-5 of the largest library output
    (+ 1e-5), the card checks' float32 tolerance; pad query rows exactly 0;
    the lse equal to the float32 logsumexp of the plain version."""
    q, k, v, valid, sm = _fwd_case(t, lengths, 1.0, seed=t)
    ref = _library_fwd(q, k, v, valid, sm)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tvalid = torch.from_numpy(valid.astype(np.int32))
    out, lse = flash_fwd_tf32(*args, tvalid, sm, split=True)
    err = np.abs(out.numpy() - ref).max()
    assert err <= 2e-5 * np.abs(ref).max() + 1e-5, (err, np.abs(ref).max())
    assert torch.all(out[~tvalid.bool()[:, None, :, None].expand_as(out)] == 0)
    _, ref_lse = tfa.flash_attention_fwd(*args, tvalid, sm)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


def test_plain_tf32_flash_forward_misses_the_tolerance():
    """q and k at 3x scale (logits of standard deviation ~9): the 3xTF32
    forward stays inside the float32 tolerance, the same forward with plain
    TF32 products misses it by more than 10x."""
    q, k, v, valid, sm = _fwd_case(256, [256, 201], 3.0, seed=3)
    ref = _library_fwd(q, k, v, valid, sm)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    tvalid = torch.from_numpy(valid.astype(np.int32))
    tol = 2e-5 * np.abs(ref).max() + 1e-5
    err3 = np.abs(flash_fwd_tf32(*args, tvalid, sm, split=True)[0].numpy() - ref).max()
    err1 = np.abs(flash_fwd_tf32(*args, tvalid, sm, split=False)[0].numpy() - ref).max()
    assert err3 <= tol, (err3, tol)
    assert err1 > 10 * tol, (err1, tol)
