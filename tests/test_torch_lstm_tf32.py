"""The precision contract of the LSTM recurrence kernels
(llm_guided_asr_tpu_torch/csrc/lstm.cu): each step's product runs on TF32
tensor cores with the 3xTF32 split (big = tf32(x), small = tf32(x - big),
small.big + big.small + big.big), cut as the kernels cut it.  The CUDA
kernels run only on the card; here their arithmetic is emulated in torch on
the CPU, with TF32 rounding as cvt.rna.tf32.f32 does it:

- forward: per gate row, W_hh h_{t-1} over the launch plan's k chunks; a
  chunk's 16-wide k blocks each feed two m16n8k8 products (k = 4t, 4t+1 and
  k = 4t+2, 4t+3 of the block, t = 0..3), whose big.big and small terms run
  in four accumulators, added as (big0 + big1) + (small0 + small1); the
  chunks added in order; then (. + bias) + xi_t and the cell in float32;
- backward: each CTA of the cluster sums W_hh^T da_{t+1} over its own 4U
  gate rows (local order gate-major, 16-row blocks as above), and the
  owner of a unit adds the CTAs' partials in rank order before dy_t.

The emulation is held against the JAX package's flax ``nn.RNN`` over
``OptimizedLSTMCell``, forward and ``jax.vjp``, from the same numpy
weights, at the card checks' tolerances (forward 1e-5 absolute + 1e-5
relative, gradients 1e-4 of the largest reference value).  The same
computation with plain TF32 products (big.big only) misses the forward
tolerance, which is why every product takes the split.  The launch plan
(ops/lstm.py launch_plan) is checked here too: it is pure Python.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu_torch.ops import lstm as tl
from test_torch_flash_tf32 import tf32

torch.set_num_threads(1)

MAX_CLUSTERS = 7  # clusters of 16 CTAs an H100 held at once (ops/lstm.py max_active_clusters)
# (B, L, H): H = 12 leaves the second CTA's slice part past H; H = 40 leaves
# three of eight CTAs empty; H = 64 takes clusters of 16 and four k chunks
CASES = [(3, 9, 12), (2, 17, 40), (5, 7, 64)]


def _parts(x: torch.Tensor, split: bool):
    big = tf32(x)
    return big, (tf32(x - big) if split else torch.zeros_like(x))


def tiled_product(a: torch.Tensor, b: torch.Tensor, k_chunks: int, split: bool) -> torch.Tensor:
    """a [M, K] b [N, K]^T -> [M, N] as the kernels sum it: K zero-padded to
    16-wide blocks, ``k_chunks`` chunks of blocks added in order, each block
    two products into four chains."""
    k = -(-a.shape[1] // 16) * 16
    a = torch.nn.functional.pad(a, (0, k - a.shape[1]))
    b = torch.nn.functional.pad(b, (0, k - b.shape[1]))
    blocks = k // 16
    t = torch.arange(4)
    out = None
    for s in range(k_chunks):
        chains = [[torch.zeros(a.shape[0], b.shape[0]) for _ in range(2)] for _ in range(2)]
        for kb in range(s * blocks // k_chunks, (s + 1) * blocks // k_chunks):
            for p in range(2):
                idx = (kb * 16 + 4 * t[:, None] + 2 * p + torch.arange(2)[None]).reshape(-1)
                ab, as_ = _parts(a[:, idx], split)
                bb, bs = _parts(b[:, idx], split)
                chains[p][1] = chains[p][1] + as_ @ bb.t()
                chains[p][1] = chains[p][1] + ab @ bs.t()
                chains[p][0] = chains[p][0] + ab @ bb.t()
        v = (chains[0][0] + chains[1][0]) + (chains[0][1] + chains[1][1])
        out = v if out is None else out + v
    return out


def lstm_fwd_tf32(xi, w, bias, split=True):
    """(y, gates, cells) as lstm_fwd computes them."""
    b, length, g4 = xi.shape
    hidden = g4 // 4
    plan = tl.launch_plan(b, hidden, False, MAX_CLUSTERS)
    h = c = torch.zeros(b, hidden)
    ys, gs, cs = [], [], []
    for t in range(length):
        pre = tiled_product(w, h, plan.k_chunks, split).t()
        i, f, g, o = ((pre + bias) + xi[:, t]).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        gs.append(torch.cat([i, f, g, o], -1))
        cs.append(c)
    return torch.stack(ys, 1), torch.stack(gs, 1), torch.stack(cs, 1)


def cta_rows(hidden: int, cluster: int, units: int, rank: int) -> torch.Tensor:
    """The gate rows CTA ``rank`` owns in its local order g U + j (-1: a
    unit past ``hidden``)."""
    j = torch.arange(units)
    unit = rank * units + j
    rows = torch.arange(4)[:, None] * hidden + unit[None]
    return torch.where(unit[None] < hidden, rows, -1).reshape(-1)


def lstm_bwd_tf32(dy, gates, cells, w, split=True):
    """da as lstm_bwd computes it from the forward's gates and cells."""
    b, length, hidden = dy.shape
    plan = tl.launch_plan(b, hidden, True, MAX_CLUSTERS)
    slices = [cta_rows(hidden, plan.cluster, plan.units, r) for r in range(plan.cluster)]
    da = torch.zeros(b, length, 4 * hidden)
    dc_carry = torch.zeros(b, hidden)
    for t in reversed(range(length)):
        dsum = torch.zeros(b, hidden)
        if t + 1 < length:
            for r, rows in enumerate(slices):
                ok = rows >= 0
                w_r = torch.where(ok[:, None], w[rows.clamp(min=0)], 0.0)  # [4U, H]
                da_r = torch.where(ok[None], da[:, t + 1, rows.clamp(min=0)], 0.0)  # [B, 4U]
                part = tiled_product(w_r.t(), da_r, 1, split).t()  # [B, H]
                dsum = part if r == 0 else dsum + part
        i, f, g, o = gates[:, t].chunk(4, dim=-1)
        ct = cells[:, t]
        cp = cells[:, t - 1] if t > 0 else torch.zeros_like(ct)
        tc = torch.tanh(ct)
        dh = dy[:, t] + dsum
        dc = dc_carry + dh * o * (1 - tc * tc)
        dc_carry = dc * f
        da[:, t] = torch.cat([dc * g * i * (1 - i), dc * cp * f * (1 - f),
                              dc * i * (1 - g * g), dh * tc * o * (1 - o)], -1)
    return da


class _JaxLSTM(nn.Module):
    hidden: int

    @nn.compact
    def __call__(self, x):
        return nn.RNN(nn.OptimizedLSTMCell(self.hidden))(x)


def _jax_params(w, bias):
    """flax's cell with identity input kernels (so its input is xi) and the
    hidden Denses of w [4H, H] and bias [4H]."""
    hidden = w.shape[1]
    eye = np.eye(4 * hidden, dtype=np.float32)
    cell = {}
    for k, gate in enumerate("ifgo"):
        cell[f"i{gate}"] = {"kernel": eye[:, k * hidden:(k + 1) * hidden]}
        cell[f"h{gate}"] = {"kernel": w[k * hidden:(k + 1) * hidden].T.copy(),
                            "bias": bias[k * hidden:(k + 1) * hidden]}
    return {"params": {"OptimizedLSTMCell_0": cell}}


def _jax_reference(xi, w, bias, dy):
    """y and the gradients of sum(y * dy) in xi, w [4H, H] and bias."""
    module = _JaxLSTM(w.shape[1])

    def run(x, hk, hb):
        params = _jax_params(w, bias)
        for k, gate in enumerate("ifgo"):
            params["params"]["OptimizedLSTMCell_0"][f"h{gate}"] = {"kernel": hk[k], "bias": hb[k]}
        return module.apply(params, x)

    hidden = w.shape[1]
    hk = jnp.stack([w[k * hidden:(k + 1) * hidden].T for k in range(4)])
    hb = jnp.stack([bias[k * hidden:(k + 1) * hidden] for k in range(4)])
    y, vjp = jax.vjp(jax.jit(run), jnp.asarray(xi), hk, hb)
    d_x, d_hk, d_hb = vjp(jnp.asarray(dy))
    d_w = np.concatenate([np.asarray(d_hk[k]).T for k in range(4)])
    return np.asarray(y), np.asarray(d_x), d_w, np.asarray(d_hb).reshape(-1)


def _inputs(b, length, hidden):
    rng = np.random.default_rng(b * 1000 + length * 10 + hidden)
    xi = (0.5 * rng.standard_normal((b, length, 4 * hidden))).astype(np.float32)
    w = (rng.standard_normal((4 * hidden, hidden)) / np.sqrt(hidden)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(4 * hidden)).astype(np.float32)
    dy = rng.standard_normal((b, length, hidden)).astype(np.float32)
    return xi, w, bias, dy


@pytest.mark.parametrize("b,length,hidden", CASES)
def test_tiled_3xtf32_recurrence_matches_flax(b, length, hidden):
    """The forward, da and the autograd function's weight gradients (da^T
    h_prev, sum of da) of the emulated kernels against flax's forward and
    VJP; plain TF32 misses the forward tolerance."""
    xi, w, bias, dy = _inputs(b, length, hidden)
    y_ref, dx_ref, dw_ref, db_ref = _jax_reference(xi, w, bias, dy)
    txi, tw, tb, tdy = (torch.from_numpy(a) for a in (xi, w, bias, dy))
    y, gates, cells = lstm_fwd_tf32(txi, tw, tb)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    da = lstm_bwd_tf32(tdy, gates, cells, tw)
    h_prev = torch.cat([torch.zeros(b, 1, hidden), y[:, :-1]], 1)
    d_w = da.reshape(-1, 4 * hidden).t() @ h_prev.reshape(-1, hidden)
    for name, got, ref in (("xi", da.numpy(), dx_ref), ("w_hh", d_w.numpy(), dw_ref),
                           ("bias", da.sum((0, 1)).numpy(), db_ref)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=name)
    plain = lstm_fwd_tf32(txi, tw, tb, split=False)[0].numpy()
    excess = np.abs(plain - y_ref) - (1e-5 + 1e-5 * np.abs(y_ref))
    assert excess.max() > 0, "plain TF32 met the float32 tolerance"


def test_emulation_matches_the_plain_loop_at_a_long_sequence():
    """Over 64 steps at H = 40 (three k chunks) the emulated forward stays
    within the forward tolerance of the port's plain loop."""
    xi, w, bias, _ = _inputs(2, 64, 40)
    txi, tw, tb = (torch.from_numpy(a) for a in (xi, w, bias))
    torch.testing.assert_close(lstm_fwd_tf32(txi, tw, tb)[0],
                               tl.lstm_recurrence_plain(txi, tw, tb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backward", [False, True])
def test_launch_plan(backward):
    """Every batch row in exactly one row group and every unit in exactly
    one CTA; shared memory within an H100 block's 227 KB; clusters of at
    most 16; W_hh in shared memory up to 320 units, read from L2 above; two
    tiles a cluster only where one would leave groups for a second wave."""
    placements = set()
    for hidden in (12, 64, 256, 320, 650, 1024):
        for b in (1, 5, 16, 64, 200):
            p = tl.launch_plan(b, hidden, backward, MAX_CLUSTERS)
            group = [r // p.rows for r in range(b)]
            assert sorted(set(group)) == list(range(p.groups))
            owner = [u // p.units for u in range(hidden)]
            assert max(owner) < p.cluster and p.units % 4 == 0
            assert p.smem_bytes <= 227 * 1024 and 1 <= p.cluster <= 16
            assert p.streamed == (hidden > tl.RESIDENT_MAX_HIDDEN)
            assert p.n_tiles == 1 or -(-b // tl.TILE_ROWS) > MAX_CLUSTERS
            placements.add(p.streamed)
    assert placements == {False, True}
    assert tl.launch_plan(64, 320, backward, MAX_CLUSTERS).n_tiles == 2
    assert tl.launch_plan(64, 320, backward, 8).n_tiles == 1
    with pytest.raises(ValueError, match="does not fit"):
        tl.launch_plan(1, 4096, backward, MAX_CLUSTERS)
