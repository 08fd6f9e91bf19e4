"""The WKV backward kernel's arithmetic (csrc/wkv.cu, wkv_bwd), emulated in
torch float32 on the CPU as the kernel tiles it, held against ``jax.vjp`` of
the JAX package's ``wkv_scan``.

The kernel cuts T into N chunks of L = ceil(T/N) steps (the forward's rule)
and runs four kernels in a fixed order, none with atomics:

1. every chunk but the last scans its steps from the zero state into a
   summary (a, b, p) and the summary's derivatives in w (ga, gb), both
   under the running maximum p;
2. every chunk but the first folds the summaries of the chunks before it
   onto the zero state: per chunk, pp decays one w per step and the carried
   dA/dw, dB/dw gain the carried A, B once per step (the extra L*A term,
   added step by step), then the summary merges in under the new maximum.
   It sweeps its steps forward (keeping q_t = gy/(B + e^(u+k)), c_t =
   q_t e^(u+k) and the step's maximum on chip) and then backward from the
   zero adjoint, into
   a reverse summary: the adjoint of (A, B) at the chunk's start, under
   its own running maximum;
3. every chunk folds the forward summaries as in 2, sweeps forward (its
   partial gw and gu), folds the reverse summaries of the chunks after it
   from the last one down, one w per step, and sweeps backward writing
   gk and gv;
4. gw and gu are the per-(batch row, chunk) partials added in a fixed
   order: batch rows in order, chunks in order within each.

N = 1 runs kernels 3 and 4 only.  The emulation divides exactly where the
kernel's fast division is within 2 ulp (its denominator lies in [1, T+1]),
and takes both exponentials of a max-normalized pair where the kernel
takes one (the other is e^0 = 1: the same bits).  The kernel is held
against its plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.ops import wkv as jwkv

torch.set_num_threads(1)

H100_SMS = 132
MIN_VALUE = -1e38


def kernel_chunks(b, t, c, sms=H100_SMS):
    """wkv_fwd_chunks, which the backward shares: the smallest power of two
    that gives 4 warps an SM, at most 32, with chunks of at least 16 steps."""
    warps, n = b * math.ceil(c / 32), 1
    while n < 32 and warps * n < 4 * sms and math.ceil(t / (2 * n)) >= 16:
        n *= 2
    return n


def _fold_decay(pp, w, steps, *carried):
    """pp decayed by w one step at a time; each (x, dx) pair of ``carried``
    gains x once per step (the normalized dx/dw of a decaying x)."""
    carried = list(carried)
    for _ in range(steps):
        pp = pp + w
        for i in range(0, len(carried), 2):
            carried[i + 1] = carried[i + 1] + carried[i]
    return pp, carried


def _merge(pp, sp, pairs):
    """Merge (carried, summary) pairs under q = max(pp, sp)."""
    q = torch.maximum(pp, sp)
    e1, e2 = torch.exp(pp - q), torch.exp(sp - q)
    return q, [e1 * x + e2 * s for x, s in pairs]


def _forward_sweep(w, u, k, v, y, gy, t0, t1, state):
    """The chunk's steps from ``state`` = (aa, bb, pp, ga, gb): per step c_t,
    q_t and the step's maximum p_t (kept on chip), and the partial gw, gu."""
    aa, bb, pp, ga, gb = state
    sw, su = torch.zeros_like(aa), torch.zeros_like(aa)
    kept = []
    for i in range(t0, t1):
        kk, vv, yy = k[:, i], v[:, i], y[:, i]
        ww = u + kk
        p = torch.maximum(pp, ww)
        e1, e2 = torch.exp(pp - p), torch.exp(ww - p)
        qq = gy[:, i] / (e1 * bb + e2)
        sw = sw + (ga - gb * yy) * e1 * qq
        su = su + (vv - yy) * e2 * qq
        kept.append((e2 * qq, qq, p))
        ww = w + pp
        p2 = torch.maximum(ww, kk)
        e1, e2 = torch.exp(ww - p2), torch.exp(kk - p2)
        ga, gb = e1 * (aa + ga), e1 * (bb + gb)
        aa, bb, pp = e1 * aa + e2 * vv, e1 * bb + e2, p2
    return kept, sw, su, (aa, bb, pp, ga, gb)


def _reverse_sweep(w, u, k, v, y, t0, t1, kept, adj, grads=None):
    """The chunk's steps backward from the adjoint ``adj`` = (ra, rb, pa) of
    (A, B) after its last step; writes gk, gv into ``grads`` when given."""
    ra, rb, pa = adj
    for i in range(t1 - 1, t0 - 1, -1):
        kk, vv, yy = k[:, i], v[:, i], y[:, i]
        cc, qq, p = kept[i - t0]
        if grads is not None:
            e2 = torch.exp(kk + pa)
            grads[0][:, i] = cc * (vv - yy) + e2 * (ra * vv + rb)
            grads[1][:, i] = cc + e2 * ra
        ww = w + pa
        q = torch.maximum(ww, -p)
        e1, e2 = torch.exp(ww - q), qq * torch.exp(-p - q)
        ra, rb, pa = e1 * ra + e2, e1 * rb - e2 * yy, q
    return ra, rb, pa


def chunked_wkv_bwd(w, u, k, v, y, gy, chunks, carry_by_steps=True):
    """(gw, gu, gk, gv) as the kernel computes them, in float32.  With
    ``carry_by_steps`` False the folds decay pp by one product L*w and the
    carried dA/dw, dB/dw gain L*A, L*B in one product."""
    b, t, c = k.shape
    n = min(chunks, max(t, 1))
    length = -(-t // n)
    bounds = [(min(j * length, t), min((j + 1) * length, t)) for j in range(n)]
    zeros = torch.zeros(b, c)
    zero_state = (zeros, zeros, torch.full((b, c), MIN_VALUE), zeros, zeros)

    def fold(summaries, state):
        aa, bb, pp, ga, gb = state
        for sa, sb, sp, sga, sgb, steps in summaries:
            if carry_by_steps:
                pp, (aa, ga, bb, gb) = _fold_decay(pp, w, steps, aa, ga, bb, gb)
            else:
                pp, ga, gb = pp + float(steps) * w, ga + float(steps) * aa, gb + float(steps) * bb
            pp, (aa, bb, ga, gb) = _merge(pp, sp, [(aa, sa), (bb, sb), (ga, sga), (gb, sgb)])
        return aa, bb, pp, ga, gb

    # 1. forward summaries of chunks 0 .. n-2 from the zero state
    fwd_sums = []
    for t0, t1 in bounds[:-1]:
        _, _, _, (sa, sb, sp, sga, sgb) = _forward_sweep(w, u, k, v, y, gy, t0, t1, zero_state)
        fwd_sums.append((sa, sb, sp, sga, sgb, t1 - t0))
    # 2. reverse summaries of chunks 1 .. n-1 from the zero adjoint
    rev_sums = {}
    for j in range(1, n):
        t0, t1 = bounds[j]
        kept, _, _, _ = _forward_sweep(w, u, k, v, y, gy, t0, t1, fold(fwd_sums[:j], zero_state))
        rev_sums[j] = _reverse_sweep(w, u, k, v, y, t0, t1, kept, zero_state[:3]) + (t1 - t0,)
    # 3. every chunk: partial gw, gu and its gk, gv
    gk, gv = torch.zeros(b, t, c), torch.zeros(b, t, c)
    parts = torch.zeros(b, n, 2, c)
    for j, (t0, t1) in enumerate(bounds):
        kept, sw, su, _ = _forward_sweep(w, u, k, v, y, gy, t0, t1, fold(fwd_sums[:j], zero_state))
        parts[:, j, 0], parts[:, j, 1] = sw, su
        ra, rb, pa = zero_state[:3]
        for i in range(n - 1, j, -1):  # the later chunks, the last one first
            sa, sb, sp, steps = rev_sums[i]
            if carry_by_steps:
                pa, _ = _fold_decay(pa, w, steps)
            else:
                pa = pa + float(steps) * w
            pa, (ra, rb) = _merge(pa, sp, [(ra, sa), (rb, sb)])
        _reverse_sweep(w, u, k, v, y, t0, t1, kept, (ra, rb, pa), (gk, gv))
    # 4. the fixed-order sum over batch rows and chunks
    gw, gu = torch.zeros(c), torch.zeros(c)
    for bi in range(b):
        for j in range(n):
            gw, gu = gw + parts[bi, j, 0], gu + parts[bi, j, 1]
    return gw, gu, gk, gv


def _inputs(seed, b, t, c, k_scale=1.0):
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.standard_normal(c) * 0.5).astype(np.float32)
    u = (rng.standard_normal(c) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, t, c)) * k_scale).astype(np.float32)
    v = rng.standard_normal((b, t, c)).astype(np.float32)
    gy = rng.standard_normal((b, t, c)).astype(np.float32)
    return w, u, k, v, gy


@jax.jit
def _jax_vjp(w, u, k, v, gy):
    y, vjp = jax.vjp(lambda *a: jwkv.wkv_scan(*a)[0], w, u, k, v)
    return (y,) + vjp(gy)


def _emulate(w, u, k, v, gy, chunks, carry_by_steps=True):
    """The emulation's gradients and the JAX reference's, as numpy."""
    y, *want = _jax_vjp(*map(jnp.asarray, (w, u, k, v, gy)))
    got = chunked_wkv_bwd(*map(torch.from_numpy, (w, u, k, v, np.array(y), gy)), chunks,
                          carry_by_steps)
    return [g.numpy() for g in got], [np.asarray(r) for r in want]


def _worst(got, want):
    """Each gradient's max |error| over 1e-4 of its largest reference value
    (the tolerance the kernel is held to): below 1 passes."""
    return {name: float(np.abs(g - r).max() / (1e-4 * np.abs(r).max() + 1e-6))
            for name, g, r in zip(("gw", "gu", "gk", "gv"), got, want)}


def test_kernel_chunk_counts_at_the_training_shapes():
    """The training shape runs unsplit; the label length of ~40 s of audio
    (24 tokens per 10 s) gives 4 chunks of 26 steps."""
    assert kernel_chunks(16, 25, 512) == 1
    assert kernel_chunks(16, 101, 512) == 4
    assert kernel_chunks(1, 101, 512) == 4  # chunks stay 16 steps or longer


@pytest.mark.parametrize("t", [1, 16, 25, 101])
@pytest.mark.parametrize("chunks", [1, 2, 4, 8])
@pytest.mark.parametrize("k_scale", [1.0, 30.0])
def test_chunked_backward_matches_jax_vjp(t, chunks, k_scale):
    """Every gradient within 1e-4 of its largest reference value, at unit k
    and at |k| up to ~100 (the running maxima carry it)."""
    b, c = 3, 16
    w, u, k, v, gy = _inputs(t * 8 + chunks + int(k_scale), b, t, c, k_scale)
    got, want = _emulate(w, u, k, v, gy, chunks)
    worst = _worst(got, want)
    assert max(worst.values()) < 1.0, worst
    assert all(np.isfinite(g).all() for g in got)


def test_very_negative_decay_and_large_k():
    """w down to about -e^4 and |k| ~ 100: a chunk's summary and the adjoint
    carry their own scales, nothing overflows."""
    b, t, c = 2, 101, 16
    w, u, k, v, gy = _inputs(11, b, t, c, 30.0)
    w = (w * np.exp(np.linspace(0.0, 4.0, c))).astype(np.float32)
    got, want = _emulate(w, u, k, v, gy, 8)
    worst = _worst(got, want)
    assert max(worst.values()) < 1.0, worst


def test_one_product_carry_rounds_further_off():
    """Why the folds decay pp one w per step and add the carried A, B to
    dA/dw, dB/dw once per step: where the carried state dominates a chunk,
    the scan rounds at every step, and at |k| ~ 100 one product L*w (and
    L*A) lands several times further from the reference."""
    w, u, k, v, gy = _inputs(2, 3, 101, 16, 30.0)
    steps = max(_worst(*_emulate(w, u, k, v, gy, 8)).values())
    product = max(_worst(*_emulate(w, u, k, v, gy, 8, carry_by_steps=False)).values())
    assert steps < 0.1 and product > 5 * steps


def test_unsplit_backward_is_the_two_sweeps():
    """One chunk is the kernel's plain two sweeps: more chunks change only
    the association, never more than the tolerance."""
    w, u, k, v, gy = _inputs(5, 2, 40, 8)
    one, want = _emulate(w, u, k, v, gy, 1)
    four, _ = _emulate(w, u, k, v, gy, 4)
    for g1, g4, r in zip(one, four, want):
        assert np.abs(g1 - g4).max() <= 1e-4 * np.abs(r).max()


def test_zero_length():
    """T = 0: no step, gw and gu are zero."""
    w, u, k, v, gy = _inputs(0, 2, 0, 8)
    gw, gu, gk, gv = chunked_wkv_bwd(*map(torch.from_numpy, (w, u, k, v, np.zeros_like(k), gy)), 4)
    assert gk.shape == (2, 0, 8) and not gw.any() and not gu.any()
