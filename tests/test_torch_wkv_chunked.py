"""The association of two reductions in the port's CUDA kernels, emulated in
torch float32 on the CPU and held against the JAX package.

- The WKV forward (csrc/wkv.cu) is a chunked scan: T is cut into N chunks
  of L = ceil(T/N) steps; each chunk is scanned from the zero state into a
  summary (a, b, p); chunk j folds the summaries of chunks 0 .. j-1 onto
  the initial state, in order, with pp' = pp + w + ... + w (one addition
  per step of the chunk, as the scan rounds them), q = max(pp', p),
  aa = aa*e^(pp'-q) + a*e^(p-q) (bb likewise), pp = q; then it rescans its
  own steps from that state.  Held against the JAX ``wkv_scan`` and the TPU
  kernel ``wkv_pallas`` in interpret mode at rtol = atol = 1e-5, on y and
  on the final state.
- The depthwise backward's dw (csrc/depthwise_conv.cu) is summed from
  per-slab partials: each (batch row, slab of rows) sums its rows in order
  into [K, C]; a block adds up to 4 consecutive slabs of a batch row in
  order into one partial, and the partials are added in a fixed order
  (eight runs of consecutive partials, then the runs in order).  Held
  against the TPU kernel ``_pallas_bwd`` in interpret mode at 1e-4 of its
  largest value.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llm_guided_asr_tpu.ops import depthwise_conv as jdw
from llm_guided_asr_tpu.ops import wkv as jwkv

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)  # the tolerance every WKV forward check holds
H100_SMS = 132
MIN_VALUE = -1e38


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX functions import pallas inside, so their TPU kernel bodies run
    in interpret mode on the CPU with no change to the JAX package."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# ---------------------------------------------------------------------------
# the chunked WKV forward
# ---------------------------------------------------------------------------

def kernel_chunks(b, t, c, sms=H100_SMS):
    """wkv_fwd_chunks: the smallest power of two that gives 4 warps an SM, at
    most 32, with chunks of at least 16 steps."""
    warps, n = b * math.ceil(c / 32), 1
    while n < 32 and warps * n < 4 * sms and math.ceil(t / (2 * n)) >= 16:
        n *= 2
    return n


def _advance(aa, bb, pp, w, kt, vt):
    ww = pp + w
    q = torch.maximum(ww, kt)
    e1, e2 = torch.exp(ww - q), torch.exp(kt - q)
    return e1 * aa + e2 * vt, e1 * bb + e2, q


def chunked_wkv(w, u, k, v, chunks, state=None, decay_by_steps=True):
    """The kernel's association: (y, final state) in float32.  With
    ``decay_by_steps`` False the fold decays the carried pp by one product,
    pp + len*w, instead of one addition of w per step."""
    b, t, c = k.shape
    n = min(chunks, max(t, 1))  # the kernel takes more chunks than steps as T
    length = -(-t // n)
    bounds = [(min(j * length, t), min((j + 1) * length, t)) for j in range(n)]
    zero = (torch.zeros(b, c), torch.zeros(b, c), torch.full((b, c), MIN_VALUE))
    summaries = []
    for t0, t1 in bounds[:-1]:
        aa, bb, pp = zero
        for i in range(t0, t1):
            aa, bb, pp = _advance(aa, bb, pp, w, k[:, i], v[:, i])
        summaries.append((aa, bb, pp, t1 - t0))
    aa0, bb0, pp0 = zero if state is None else state
    ys, final = [], None
    for j, (t0, t1) in enumerate(bounds):
        aa, bb, pp = aa0, bb0, pp0
        for sa, sb, sp, steps in summaries[:j]:  # fold chunks 0 .. j-1 in order
            ww = pp
            if decay_by_steps:
                for _ in range(steps):
                    ww = ww + w
            else:
                ww = pp + float(steps) * w
            q = torch.maximum(ww, sp)
            e1, e2 = torch.exp(ww - q), torch.exp(sp - q)
            aa, bb, pp = e1 * aa + e2 * sa, e1 * bb + e2 * sb, q
        for i in range(t0, t1):  # rescan from the carried state
            ww = u + k[:, i]
            q = torch.maximum(pp, ww)
            e1, e2 = torch.exp(pp - q), torch.exp(ww - q)
            ys.append((e1 * aa + e2 * v[:, i]) / (e1 * bb + e2))
            aa, bb, pp = _advance(aa, bb, pp, w, k[:, i], v[:, i])
        final = (aa, bb, pp)
    y = torch.stack(ys, 1) if ys else torch.zeros(b, 0, c)
    return y, final


def _wkv_inputs(seed, b, t, c, k_scale=1.0):
    rng = np.random.default_rng(seed)
    w = -np.exp(rng.standard_normal(c) * 0.5).astype(np.float32)
    u = (rng.standard_normal(c) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, t, c)) * k_scale).astype(np.float32)
    v = rng.standard_normal((b, t, c)).astype(np.float32)
    return w, u, k, v


def _assert_wkv_close(got, want):
    (y, state), (jy, jstate) = got, want
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for name, s, js in zip(("aa", "bb", "pp"), state, jstate):
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL, err_msg=name)


@jax.jit
def _jax_scan(w, u, k, v, aa, bb, pp):
    return jwkv.wkv_scan(w, u, k, v, (aa, bb, pp))


def test_kernel_chunk_counts_at_the_transducer_shapes():
    """What the cases below take as the serving shapes' chunk counts."""
    assert kernel_chunks(5, 201, 512) == 8    # beam 5: chunks of 26 steps
    assert kernel_chunks(1, 313, 512) == 16   # greedy 10 s: chunks of 20 steps
    assert kernel_chunks(16, 25, 512) == 1    # training: unsplit
    assert kernel_chunks(1, 2000, 512) == 32  # the most chunks


@pytest.mark.parametrize("b,t,c,chunks,k_scale,given_state", [
    (5, 201, 16, kernel_chunks(5, 201, 512), 1.0, False),  # beam-5 serving
    (1, 313, 16, kernel_chunks(1, 313, 512), 1.0, False),  # greedy serving
    (2, 201, 16, 8, 30.0, False),   # |k| up to ~100: the running maximum carries it
    (1, 313, 16, 16, 30.0, True),   # the same at the greedy count, from a given state
    (2, 64, 8, 16, 1.0, True),      # a given initial state, T a multiple of the chunks
    (3, 50, 8, 16, 30.0, True),     # T not a multiple: a short last chunk
    (2, 5, 8, 16, 1.0, True),       # T below the chunk count
    (1, 31, 8, 3, 1.0, False),      # a count that is no power of two
])
def test_chunked_wkv_matches_jax(interpret_pallas, b, t, c, chunks, k_scale, given_state):
    w, u, k, v = _wkv_inputs(b * t + c + chunks, b, t, c, k_scale)
    if given_state:  # a state carried out of an earlier stretch, as a chained stream has
        _, _, k0, v0 = _wkv_inputs(7, b, 9, c, k_scale)
        state = jwkv.wkv_scan(*map(jnp.asarray, (w, u, k0, v0)))[1]
    else:
        state = jwkv.wkv_init_state(b, c)
    tstate = tuple(torch.from_numpy(np.array(s)) for s in state)
    got = chunked_wkv(*map(torch.from_numpy, (w, u, k, v)), chunks, tstate)
    jargs = tuple(map(jnp.asarray, (w, u, k, v)))
    _assert_wkv_close(got, _jax_scan(*jargs, *state))
    _assert_wkv_close(got, jwkv.wkv_pallas(*jargs, state))
    if k_scale > 1:  # no overflow anywhere
        assert np.isfinite(got[0].numpy()).all() and float(got[1][2].max()) > 20


def test_one_product_decay_misses_the_tolerance():
    """Why the fold adds w once per step: where the carried state dominates
    a chunk, the scan's pp is pp + w + ... + w rounded at every step, and at
    |pp| ~ 100 one product pp + len*w rounds differently enough to move y
    past the tolerance, while the additions keep it well inside."""
    b, t, c, chunks = 4, 313, 64, 16
    w, u, k, v = _wkv_inputs(2, b, t, c, 30.0)
    want = np.asarray(_jax_scan(*map(jnp.asarray, (w, u, k, v)), *jwkv.wkv_init_state(b, c))[0])

    def worst(decay_by_steps):  # the largest |error| over the tolerance allowed there
        y, _ = chunked_wkv(*map(torch.from_numpy, (w, u, k, v)), chunks,
                           decay_by_steps=decay_by_steps)
        return float((np.abs(y.numpy() - want) / (1e-5 + 1e-5 * np.abs(want))).max())

    assert worst(True) < 0.5 and worst(False) > 2.0


def test_unsplit_scan_is_the_sequential_recurrence():
    """One chunk is the sequential step, bit for bit; with no given state the
    second chunk carries in exactly the first chunk's summary."""
    w, u, k, v = map(torch.from_numpy, _wkv_inputs(3, 2, 40, 8))
    y1, s1 = chunked_wkv(w, u, k, v, 1)
    aa, bb, pp = torch.zeros(2, 8), torch.zeros(2, 8), torch.full((2, 8), MIN_VALUE)
    for i in range(40):
        aa, bb, pp = _advance(aa, bb, pp, w, k[:, i], v[:, i])
    assert all(torch.equal(a, r) for a, r in zip(s1, (aa, bb, pp)))
    y2, s2 = chunked_wkv(w, u, k, v, 2)
    assert torch.equal(y2, y1) and all(map(torch.equal, s2, s1))


# ---------------------------------------------------------------------------
# the depthwise backward's dw
# ---------------------------------------------------------------------------

def kernel_slabs(b, t, c, k_size, sms=H100_SMS):
    """dwconv1d_bwd_slabs: the smallest power of two that gives 12 warps an SM,
    at most 64, with slabs of at least K rows."""
    warps, n = b * math.ceil(c / 32), 1
    while n < 64 and warps * n < 12 * sms and math.ceil(t / (2 * n)) >= k_size:
        n *= 2
    return n


def slab_dw(x, dy, k_size, slabs, block_slabs=4, sum_warps=8):
    """The kernel's association of dw: per (batch row, slab) sums over the
    slab's rows in order, min(block_slabs, slabs) consecutive slabs added in
    order into a partial, then the partials in a fixed order."""
    b, t, c = x.shape
    pad_l = (k_size - 1) // 2
    xp = F.pad(x, (0, 0, pad_l, k_size - 1 - pad_l))
    rows = -(-t // slabs)
    acc = torch.zeros(b, slabs, k_size, c)
    taps = torch.arange(k_size)
    for i in range(rows):
        ts = [s * rows + i for s in range(slabs)]
        live = torch.tensor([tt < t for tt in ts], dtype=torch.float32)[None, :, None, None]
        ts = [min(tt, t - 1) for tt in ts]
        g = dy[:, ts][:, :, None, :]                       # [B, S, 1, C]
        win = xp[:, torch.tensor(ts)[:, None] + taps]       # [B, S, K, C]
        acc = acc + live * (g * win)
    per_block = min(block_slabs, slabs)
    blocks = acc.reshape(b * slabs // per_block, per_block, k_size, c)
    parts = blocks[:, 0]
    for w in range(1, per_block):
        parts = parts + blocks[:, w]
    n = parts.shape[0]
    per = -(-n // sum_warps)
    runs = []
    for g in range(sum_warps):
        run = torch.zeros(k_size, c)
        for q in range(min(g * per, n), min((g + 1) * per, n)):
            run = run + parts[q]
        runs.append(run)
    total = runs[0]
    for run in runs[1:]:
        total = total + run
    return total


def test_kernel_slab_counts_at_the_training_shapes():
    assert kernel_slabs(64, 312, 256, 31) == 4  # train-1: slabs of 78 rows
    assert kernel_slabs(64, 312, 256, 8) == 4
    assert kernel_slabs(16, 312, 256, 31) == 8   # train-transducer: 39 rows
    assert kernel_slabs(8, 1874, 256, 31) == 32  # train-flash: 59 rows


@pytest.mark.parametrize("b,t,c,k_size,slabs", [
    (4, 78, 16, 31, 1),   # one slab a batch row
    (4, 78, 16, 31, 4),   # the training shape's slabs, cut down in B and C
    (3, 50, 16, 8, kernel_slabs(3, 50, 16, 8)),  # an even K, the rule's slabs
    (2, 37, 8, 15, 2),    # rows not a multiple of the slabs, two slabs a block
    (9, 20, 8, 5, 16),    # more partials than the sum's eight runs, some slabs empty
    (2, 6, 8, 15, 2),     # T shorter than K
])
def test_slab_dw_matches_the_tpu_kernel(interpret_pallas, b, t, c, k_size, slabs):
    rng = np.random.default_rng(b * t + k_size)
    x, dy = (rng.standard_normal((b, t, c)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((k_size, c)).astype(np.float32)
    _, ref = jdw._pallas_bwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy))
    ref = np.asarray(ref)
    got = slab_dw(torch.from_numpy(x), torch.from_numpy(dy), k_size, slabs).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
