"""The precision contract of the rel-pos attention kernels
(llm_guided_asr_tpu_torch/csrc/rel_attention.cu): every product runs on TF32
tensor cores with the 3xTF32 split (big = tf32(x), small = tf32(x - big),
small.big + big.small + big.big), tiled as the kernels tile it at head dim
64.  The CUDA kernels run only on the card; here their arithmetic is
emulated in torch on the CPU, with TF32 rounding as cvt.rna.tf32.f32 does
it:

- forward: per warp tile of 16 query rows and key tile of 32 keys, S = qu
  k^T plus the positional band qv . P_rows^T ([16, 48], the 47 positional
  rows the tile touches) read skewed, s2[ii][jj] = band[ii][15 - ii + jj];
  the online base-2 softmax over key tiles, each tile's P V in a fresh
  accumulator;
- backward, query-major: S, dP = dO V^T, dS, dQu = dS K and dQv =
  band(dS) . P_rows, dS written skewed into a [16, 48] band;
- backward, key-major (blocks of 64 keys, query tiles of 16 from the last
  to the first): the block's positional band qv . P_rows^T ([16, 80]) read
  skewed into S^T, dP^T = V dO^T, dV = P^T dO, dK = dS^T Qu, and dp =
  band(dS^T)^T . Qv over the [80, 64] window of positional rows.

The emulation is held against the JAX package's rel_flash_attention,
forward and VJP, run in interpret mode as tests/test_torch_kernels.py runs
it, at the card checks' float32 tolerances (forward 1e-5 absolute,
gradients 1e-4 of the largest reference gradient).  The same computation
with plain TF32 products (big.big only) misses them, which is why every
product takes the split.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.ops.rel_attention import rel_attention_pad_pos, rel_flash_attention
from llm_guided_asr_tpu_torch.ops import rel_attention as tra
from test_torch_flash_tf32 import tf32_matmul

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
MASKED2 = np.float32(-1e30) * np.float32(LOG2E)  # a masked key's score in base 2
BK, ROWS, BQ = 32, 64, 16  # the kernels' tiles at head dim 64


def _pad_rows(x, n):
    """x [..., t, d] zero-padded to n rows."""
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[-2]))


def _p_rows(p, r0, n):
    """Positional rows [r0, r0 + n) of p [H, 2T-1, dk], 0 outside the table."""
    r = torch.arange(r0, r0 + n)
    ok = (r >= 0) & (r < p.shape[1])
    return torch.where(ok[:, None], p[:, r.clamp(0, p.shape[1] - 1)], 0.0)  # [H, n, dk]


def _skew(rows, cols, shift):
    """index [rows, cols] = shift - row + col (the band column of each score)."""
    return shift - torch.arange(rows)[:, None] + torch.arange(cols)[None, :]


def _state(valid, j0, n, t):
    """key state of keys [j0, j0 + n): 2 valid, 1 masked, 0 past T; [B, 1, 1, n]."""
    j = torch.arange(j0, j0 + n)
    inside = j < t
    v = torch.where(inside[None], valid[:, j.clamp(max=t - 1)] != 0, False)
    return torch.where(inside[None], torch.where(v, 2, 1), 0)[:, None, None, :]


def rel_fwd_tf32(qu, qv, k, v, p, valid, sm, seed, rate, split):
    """(out, lse) as rel_attention_fwd computes them, per warp tile of 16
    query rows and key tile of BK keys."""
    b, h, t, dk = qu.shape
    tq, tk = -(-t // 16) * 16, -(-t // BK) * BK
    qu_, qv_ = _pad_rows(qu, tq), _pad_rows(qv, tq)
    k_, v_ = _pad_rows(k, tk), _pad_rows(v, tk)
    keep = (tra.dropout_keep_mask(seed, torch.arange(h)[None, :], torch.arange(b)[:, None],
                                  tq, tk, rate) if rate > 0 else None)
    out = torch.zeros(b, h, tq, dk)
    lse = torch.zeros(b, h, tq)
    idx = _skew(16, BK, 15).expand(b, h, 16, BK)
    for i0 in range(0, tq, 16):
        qu_w, qv_w = qu_[:, :, i0:i0 + 16], qv_[:, :, i0:i0 + 16]
        m = torch.full((b, h, 16, 1), -math.inf)
        l = torch.zeros(b, h, 16, 1)
        acc = torch.zeros(b, h, 16, dk)
        for j0 in range(0, t, BK):
            band = tf32_matmul(qv_w, _p_rows(p, (t - 1) - (i0 + 15) + j0, 16 + BK)
                               .transpose(-1, -2)[None], split)
            s = tf32_matmul(qu_w, k_[:, :, j0:j0 + BK].transpose(-1, -2), split)
            s = s + band.gather(-1, idx)
            st = _state(valid, j0, BK, t)
            s = torch.where(st == 2, s * (sm * LOG2E), torch.where(st == 1, MASKED2, -math.inf))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            pe = torch.exp2(s - m_new)
            l = l * alpha + pe.sum(-1, keepdim=True)
            if keep is not None:
                pe = torch.where(keep[:, :, i0:i0 + 16, j0:j0 + BK], pe / (1 - rate), 0.0)
            acc = acc * alpha + tf32_matmul(pe, v_[:, :, j0:j0 + BK], split)  # fresh accumulator
            m = m_new
        out[:, :, i0:i0 + 16] = acc / l
        lse[:, :, i0:i0 + 16] = ((m + torch.log2(l)) / LOG2E)[..., 0]
    return out[:, :, :t], lse[:, :, :t]


def rel_bwd_tf32(qu, qv, k, v, p, valid, dout, sm, seed, rate, split):
    """(dqu, dqv, dk, dv, dp) as rel_attention_bwd computes them: the
    forward's lse, delta = rowsum(out dout), then the query-major and the
    key-major kernels' products."""
    b, h, t, dk = qu.shape
    out, lse = rel_fwd_tf32(qu, qv, k, v, p, valid, sm, seed, rate, split)
    delta = (out * dout).sum(-1)
    tq, tk = -(-t // 16) * 16, -(-t // ROWS) * ROWS
    t_all = max(tq, tk, -(-t // BK) * BK)
    pad = lambda x: _pad_rows(x, t_all)  # noqa: E731
    qu_, qv_, k_, v_, do_ = map(pad, (qu, qv, k, v, dout))
    lse_ = torch.nn.functional.pad(lse, (0, t_all - t))
    dlt_ = torch.nn.functional.pad(delta, (0, t_all - t))
    keep = (tra.dropout_keep_mask(seed, torch.arange(h)[None, :], torch.arange(b)[:, None],
                                  t_all, t_all, rate) if rate > 0 else None)
    inv = 1.0 / (1.0 - rate)
    none_valid = ~(valid != 0).any(dim=1)[:, None, None, None]

    # query-major: dqu, dqv
    dqu, dqv = torch.zeros(b, h, t_all, dk), torch.zeros(b, h, t_all, dk)
    idx = _skew(16, BK, 15).expand(b, h, 16, BK)
    for i0 in range(0, tq, 16):
        rows = slice(i0, i0 + 16)
        row_ok = (torch.arange(i0, i0 + 16) < t)[None, None, :, None]
        for j0 in range(0, t, BK):
            keys = slice(j0, j0 + BK)
            prow = _p_rows(p, (t - 1) - (i0 + 15) + j0, 16 + BK)[None]  # [1, H, 48, dk]
            s = tf32_matmul(qu_[:, :, rows], k_[:, :, keys].transpose(-1, -2), split)
            s = s + tf32_matmul(qv_[:, :, rows], prow.transpose(-1, -2), split).gather(-1, idx)
            dp = tf32_matmul(do_[:, :, rows], v_[:, :, keys].transpose(-1, -2), split)
            if keep is not None:
                dp = torch.where(keep[:, :, rows, keys], dp * inv, 0.0)
            ok = (_state(valid, j0, BK, t) == 2) & row_ok
            pr = torch.exp2(s * (sm * LOG2E) - lse_[:, :, rows, None] * LOG2E)
            ds = torch.where(ok, pr * (dp - dlt_[:, :, rows, None]) * sm, 0.0)
            dqu[:, :, rows] += tf32_matmul(ds, k_[:, :, keys], split)
            band = torch.zeros(b, h, 16, 16 + BK).scatter_(-1, idx, ds)
            dqv[:, :, rows] += tf32_matmul(band, prow, split)

    # key-major: dk, dv, dp (query tiles from the last to the first)
    dk_, dv_ = torch.zeros(b, h, t_all, dk), torch.zeros(b, h, t_all, dk)
    dpos = torch.zeros(h, 2 * t - 1, dk)
    nq, w = -(-t // BQ), ROWS + BQ
    sidx = _skew(BQ, ROWS, BQ - 1).expand(b, h, BQ, ROWS)  # [ii][jj] -> band column
    for j0 in range(0, t, ROWS):
        keys = slice(j0, j0 + ROWS)
        st = _state(valid, j0, ROWS, t).transpose(-1, -2)  # [B, 1, ROWS, 1]
        for i0 in range((nq - 1) * BQ, -1, -BQ):
            q = slice(i0, i0 + BQ)
            rb = (t - 1) - (i0 + BQ - 1) + j0
            prow = _p_rows(p, rb, w)[None]  # [1, H, W, dk]
            sb = tf32_matmul(qv_[:, :, q], prow.transpose(-1, -2), split)  # [B, H, BQ, W]
            s_t = tf32_matmul(k_[:, :, keys], qu_[:, :, q].transpose(-1, -2), split)
            s_t = s_t + sb.gather(-1, sidx).transpose(-1, -2)
            dp_t = tf32_matmul(v_[:, :, keys], do_[:, :, q].transpose(-1, -2), split)
            q_in = (torch.arange(i0, i0 + BQ) < t)[None, None, None, :]
            pr = torch.where(st == 2, torch.exp2(s_t * (sm * LOG2E)
                                                 - lse_[:, :, None, q] * LOG2E),
                             torch.where(none_valid, 1.0 / t, 0.0))
            pd, dpd = pr, dp_t
            if keep is not None:
                kp = keep[:, :, q, keys].transpose(-1, -2)
                pd, dpd = torch.where(kp, pr * inv, 0.0), torch.where(kp, dp_t * inv, 0.0)
            inside = q_in & (st != 0)
            ds_t = torch.where(inside & (st == 2), pr * (dpd - dlt_[:, :, None, q]) * sm, 0.0)
            pd = torch.where(inside, pd, 0.0)
            dv_[:, :, keys] += tf32_matmul(pd, do_[:, :, q], split)
            dk_[:, :, keys] += tf32_matmul(ds_t, qu_[:, :, q], split)
            x = torch.zeros(b, h, BQ, w).scatter_(-1, sidx, ds_t.transpose(-1, -2))
            y = tf32_matmul(x.transpose(-1, -2), qv_[:, :, q], split).sum(0)  # [H, W, dk]
            r = torch.arange(rb, rb + w)
            ok = (r >= 0) & (r < 2 * t - 1)
            dpos[:, r[ok]] += y[:, ok]
    return dqu[:, :, :t], dqv[:, :, :t], dk_[:, :, :t], dv_[:, :, :t], dpos


def _inputs(t, lengths, seed, logit_scale=1.0, dk=64, h=2):
    """Unit-scale operands (logits of standard deviation ~1.4 at dk 64), qu and
    qv times ``logit_scale``."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    qu, qv = (logit_scale * mk(b, h, t, dk) for _ in range(2))
    k, v, dout = mk(b, h, t, dk), mk(b, h, t, dk), mk(b, h, t, dk)
    p_dense = mk(2 * t - 1, h, dk)  # [2T-1, H, dk], the flax module's layout
    valid = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return qu, qv, k, v, p_dense, valid, dout


def _jax_fwd_vjp(qu, qv, k, v, p_dense, valid, dout, sm, seed, rate):
    """rel_flash_attention's output and VJP (interpret mode on the CPU), cut
    back from the kernel's padded layout to [B, H, T, dk] and [H, 2T-1, dk]."""
    t = qu.shape[2]
    tp = -(-t // 128) * 128
    jpad = lambda x: jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, tp - t), (0, 0)))  # noqa: E731
    j_valid = jnp.pad(jnp.asarray(valid), ((0, 0), (0, tp - t)))

    def fn(qu_, qv_, k_, v_, p_):
        return rel_flash_attention(qu_, qv_, k_, v_, p_, j_valid, sm, seed=jnp.int32(seed),
                                   dropout_rate=rate)

    out, pull = jax.vjp(fn, jpad(qu), jpad(qv), jpad(k), jpad(v),
                        rel_attention_pad_pos(jnp.asarray(p_dense), t, tp))
    grads = [np.asarray(g) for g in pull(jpad(dout))]
    off = tp - t
    return (np.asarray(out)[:, :, :t], [g[:, :, :t] for g in grads[:4]]
            + [grads[4][:, off:off + 2 * t - 1]])


def _torch_args(qu, qv, k, v, p_dense, valid, dout):
    T = torch.from_numpy
    return (T(qu), T(qv), T(k), T(v), T(np.moveaxis(p_dense, 1, 0).copy()), T(valid), T(dout))


CASES = [
    (40, [40, 33], 0.0),   # one key tile and a ragged one; a query tile past T
    (77, [77, 50], 0.1),   # T not a multiple of the tiles, with dropout
    (80, [80, 61], 0.0),   # two key blocks of the key-major kernel
    (80, [80, 23], 0.1),
]


@functools.lru_cache(maxsize=None)
def _case(t, lengths, rate):
    """A case's inputs (torch), its dropout seed, and the JAX kernel's output
    and gradients, shared by the forward and the backward tests."""
    inputs = _inputs(t, list(lengths), seed=t)
    seed = 1234 + t
    ref, refs = _jax_fwd_vjp(*inputs, 1.0 / 8.0, seed, rate)
    return _torch_args(*inputs), seed, ref, refs


@pytest.mark.parametrize("t,lengths,rate", CASES)
def test_3xtf32_rel_forward_matches_the_jax_kernel(t, lengths, rate):
    """The forward's 3xTF32 output within 1e-5 of the JAX kernel's (the card
    checks' float32 tolerance) and its lse within 1e-5 of the plain
    logsumexp."""
    args, seed, ref, _ = _case(t, tuple(lengths), rate)
    sm = 1.0 / 8.0
    out, lse = rel_fwd_tf32(*args[:6], sm, seed, rate, split=True)
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-5, (err, np.abs(ref).max())
    _, ref_lse = tra.rel_attention_fwd(*args[:6], sm, seed, rate)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,lengths,rate", CASES)
def test_3xtf32_rel_backward_matches_the_jax_vjp(t, lengths, rate):
    """The five gradients of the 3xTF32 backward within 1e-4 of the largest
    gradient of the JAX kernel's VJP, as on the card."""
    args, seed, _, refs = _case(t, tuple(lengths), rate)
    sm = 1.0 / 8.0
    grads = rel_bwd_tf32(*args[:6], args[6], sm, seed, rate, split=True)
    for name, g, ref in zip(("dqu", "dqv", "dk", "dv", "dp"), grads, refs):
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_3xtf32_rel_all_masked_batch_row_matches_the_plain_version():
    """A batch row with no valid key averages v over its T keys (scores all
    -1e30, as the plain version has it; the JAX kernel's padded keys would
    join that average, so the plain version is the reference here): the
    forward and the gradients, whose masked scores pass no gradient."""
    t, lengths = 50, [50, 0]
    qu, qv, k, v, p_dense, valid, dout = _inputs(t, lengths, seed=9)
    args = _torch_args(qu, qv, k, v, p_dense, valid, dout)
    sm = 1.0 / 8.0
    out, _ = rel_fwd_tf32(*args[:6], sm, 5, 0.1, split=True)
    ref = tra.rel_attention_plain(*args[:6], sm, 5, 0.1)
    assert (out - ref).abs().max().item() <= 1e-5
    grads = rel_bwd_tf32(*args[:6], args[6], sm, 5, 0.1, split=True)
    refs = tra.rel_attention_bwd_plain(*args[:6], args[6], sm, 5, 0.1)
    for name, g, r in zip(("dqu", "dqv", "dk", "dv", "dp"), grads, refs):
        err = (g - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item() + 1e-6, (name, err)


def test_plain_tf32_rel_products_miss_the_tolerances():
    """Logits at 3x (standard deviation ~4): the 3xTF32 forward and gradients
    stay inside the float32 tolerances, the same computation with plain TF32
    products misses both by more than 10x."""
    t, lengths = 64, [64, 47]
    qu, qv, k, v, p_dense, valid, dout = _inputs(t, lengths, seed=3, logit_scale=3.0)
    sm, seed, rate = 1.0 / 8.0, 11, 0.1
    ref, refs = _jax_fwd_vjp(qu, qv, k, v, p_dense, valid, dout, sm, seed, rate)
    args = _torch_args(qu, qv, k, v, p_dense, valid, dout)
    for split in (True, False):
        out, _ = rel_fwd_tf32(*args[:6], sm, seed, rate, split=split)
        err = np.abs(out.numpy() - ref).max()
        grads = rel_bwd_tf32(*args[:6], args[6], sm, seed, rate, split=split)
        g_err = max(np.abs(g.numpy() - r).max() / np.abs(r).max() for g, r in zip(grads, refs))
        print(f"{'3xTF32' if split else 'plain TF32'}: forward error {err:.2e} "
              f"(tolerance 1e-5), gradients {g_err:.2e} of the largest (1e-4)")
        if split:
            assert err <= 1e-5 and g_err <= 1e-4, (err, g_err)
        else:
            assert err > 10 * 1e-5 and g_err > 10 * 1e-4, (err, g_err)
