"""The port's CUDA kernels on the card, held against their plain versions.

Needs a CUDA card and nvcc; every test skips without a card.  This file
imports neither JAX nor the JAX package, so that it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from llm_guided_asr_tpu_torch.convert import init_weights
from llm_guided_asr_tpu_torch.models import conformer as tconf
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.train.optim import build_optimizer
from llm_guided_asr_tpu_torch.train.trainer import init_train_state, make_fused_train_step
from llm_guided_asr_tpu_torch.ops import depthwise_conv as tdw
from llm_guided_asr_tpu_torch.ops import flash_attention as tfa
from llm_guided_asr_tpu_torch.ops import rel_attention as tra
from llm_guided_asr_tpu_torch.ops import wkv as twkv

# bf16 outputs are rounded to 8 mantissa bits; float32 differs only by the
# order of the sums
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


# encoder frames of 10.0, 7.3, 4.1, 10.0, 7.3, 4.1, 10.0 and 7.3 s of audio
# in one batch padded to 10 s (chip_smoke.py phase 12)
SERVE_BATCH_LENS = [312, 229, 129, 312, 229, 129, 312, 229]


def _rel_attention_tol(ref):
    """float32: the order of the sums; bfloat16: at most one unit in the last
    place of the output, 2**-7 of the largest one."""
    if ref.dtype == torch.float32:
        return 1e-5
    return 2.0 ** -7 * ref.float().abs().max().item() + 1e-5


def _counts():
    return {**tra.KERNEL.launches, **tdw.KERNEL.launches, **twkv.KERNEL.launches,
            **tfa.KERNEL.launches}


def _grad_tol(ref: torch.Tensor) -> float:
    """float32: 1e-4 of the largest reference gradient (the order of the
    sums); bfloat16: 2**-6 of it, four units in the last place, which
    covers the rounding of the stored gradients and of the bfloat16 output
    the kernel's delta is taken from."""
    scale = ref.float().abs().max().item()
    return (1e-4 if ref.dtype == torch.float32 else 2.0 ** -6) * scale + 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(rng, *shape, scale=0.3):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,dk,lengths", [
    (1, 4, 312, 64, [312]),  # the Conformer's shape at 10 s of audio
    (1, 4, 312, 64, [287]),
    (2, 3, 77, 32, [77, 50]),
    (1, 2, 130, 128, [101]),
    (2, 2, 5, 16, [5, 1]),
    (2, 4, 100, 36, [100, 71]),  # a head dim padded inside the kernel (144-wide Conformer)
    (1, 4, 937, 64, [937]),  # B = 1 at 30 s and 60 s of audio: the key splits' grids
    (1, 4, 1874, 64, [1874]),
    (8, 4, 312, 64, SERVE_BATCH_LENS),  # Speech2Text.batch_call of 8 ragged requests
])
def test_rel_attention_kernel_matches_plain(card, dtype, b, h, t, dk, lengths):
    # unit-scale inputs: a peaked softmax, so that a wrong positional term
    # moves outputs far beyond the bf16 tolerance
    rng = np.random.default_rng(t)
    qu, qv, k, v = (_rand(rng, b, h, t, dk, scale=1.0).to(card, dtype) for _ in range(4))
    p = _rand(rng, h, 2 * t - 1, dk, scale=1.0).to(card, dtype)
    kv_valid = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).to(card, torch.int32)
    before = dict(tra.KERNEL.launches)
    out = tra.rel_attention(qu, qv, k, v, p, kv_valid, 1.0 / math.sqrt(dk))
    torch.cuda.synchronize()
    assert tra.KERNEL.launches == {**before, "rel_attention_fwd": before["rel_attention_fwd"] + 1}
    ref = tra.rel_attention_plain(qu, qv, k, v, p, kv_valid, 1.0 / math.sqrt(dk))
    assert out.dtype == dtype and out.shape == qu.shape
    assert (out.float() - ref.float()).abs().max().item() <= _rel_attention_tol(ref)


# the stencil kernel's tap counts (compiled: 31, 15, 8; any other K at run
# time: 1, 2, 33), T shorter than K, C not a multiple of the 32-channel
# blocks, and grids that take 2, 4 and 16 rows a thread on an H100's 132
# SMs (the last three rows: 16, 4, 16)
DW_CASES = [
    (1, 312, 256, 15), (1, 312, 70, 33), (3, 40, 70, 1), (1, 20, 256, 2),
    (3, 5, 70, 15), (1, 30, 256, 31), (1, 7, 256, 33),
    (16, 312, 256, 31), (4, 312, 256, 8), (48, 100, 70, 15),
    (8, 312, 256, 31),  # the batched serving shape
    (1, 40, 256, 15),  # the streaming encoder's block (serve-stream)
    (1, 312, 512, 31), (64, 312, 512, 31),  # the E-Branchformer's cgMLP (serve-ebf, train-ebf)
    # the MultiConvformer's cgMLP: the runtime-K taps at 512 channels and the
    # merge conv at 2048 (serve-enc, train-enc)
    (1, 312, 512, 7), (64, 312, 512, 7), (1, 312, 512, 23), (64, 312, 512, 23),
    (1, 312, 2048, 31), (64, 312, 2048, 31),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k_size", [(1, 312, 256, 31), (2, 100, 256, 8), (3, 17, 70, 5)]
                         + DW_CASES)
def test_depthwise_kernel_matches_plain(card, dtype, b, t, c, k_size):
    rng = np.random.default_rng(k_size)
    x = _rand(rng, b, t, c, scale=1.0).to(card, dtype)
    w = _rand(rng, k_size, c, scale=1.0).to(card, dtype)
    before = dict(tdw.KERNEL.launches)
    out = tdw.depthwise_conv1d(x, w)
    torch.cuda.synchronize()
    assert tdw.KERNEL.launches == {**before, "dwconv1d_fwd": before["dwconv1d_fwd"] + 1}
    ref = tdw.depthwise_conv1d_plain(x, w)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype] * k_size


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(card):
    x = torch.zeros(1, 8, 4, device=card).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tdw.depthwise_conv1d(x, torch.zeros(3, 8, device=card))
    q = torch.zeros(1, 2, 4, 8, device=card)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 2, 4, 256, device=card)
        tra.rel_attention(big, big, big, big, torch.zeros(2, 7, 256, device=card),
                          torch.ones(1, 4, dtype=torch.int32, device=card), 1.0)
    with pytest.raises(ValueError, match="different devices"):
        tra.rel_attention(q, q, q, q.cpu(), torch.zeros(2, 7, 8, device=card),
                          torch.ones(1, 4, dtype=torch.int32, device=card), 1.0)


@pytest.mark.gpu
def test_conformer_on_the_card_matches_the_cpu(card):
    """Two blocks with mixed lengths: the kernels (card) against the plain
    versions (CPU), one launch of each kernel per block."""
    cfg = tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=128,
                                num_blocks=2, macaron_style=True, cnn_module_kernel=15)
    torch.manual_seed(0)
    cpu = tconf.ConformerEncoder(cfg, 40, device="cpu").eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.normal_(0.0, 0.1)
    gpu = tconf.ConformerEncoder(cfg, 40, device=card).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    feats = _rand(rng, 3, 157, 40, scale=1.0)
    lengths = torch.tensor([157, 120, 61])
    before = _counts()
    with torch.no_grad():
        out_gpu, lens_gpu = gpu(feats.to(card), lengths.to(card))
        out_cpu, lens_cpu = cpu(feats, lengths)
    torch.cuda.synchronize()
    assert _counts() == {**before, "rel_attention_fwd": before["rel_attention_fwd"] + 2,
                         "dwconv1d_fwd": before["dwconv1d_fwd"] + 2}
    assert torch.equal(lens_gpu.cpu(), lens_cpu)
    torch.testing.assert_close(out_gpu.cpu(), out_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,h,t,dk,lengths", [
    (2, 4, 312, 64, [312, 250]),  # the Conformer's training shape, two batch rows
    (2, 3, 77, 32, [77, 50]),
    (1, 2, 130, 128, [101]),
    (2, 2, 5, 16, [5, 1]),
    (2, 4, 100, 36, [100, 71]),
])
def test_rel_attention_backward_matches_plain(card, dtype, rate, b, h, t, dk, lengths):
    """The kernels under autograd (forward with dropout, then the backward)
    against autograd through the plain version with the same hash mask."""
    _check_rel_backward(card, dtype, rate, b, h, t, dk, lengths)


def _check_rel_backward(card, dtype, rate, b, h, t, dk, lengths, logit_scale=1.0):
    rng = np.random.default_rng(t + dk)
    qu, qv = (_rand(rng, b, h, t, dk, scale=logit_scale).to(card, dtype) for _ in range(2))
    k, v = (_rand(rng, b, h, t, dk, scale=1.0).to(card, dtype) for _ in range(2))
    p = _rand(rng, h, 2 * t - 1, dk, scale=1.0).to(card, dtype)
    dout = _rand(rng, b, h, t, dk, scale=1.0).to(card, dtype)
    kv_valid = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).to(card, torch.int32)
    sm, seed = 1.0 / math.sqrt(dk), -123456789
    leaves = [x.clone().requires_grad_(True) for x in (qu, qv, k, v, p)]
    before = _counts()
    out = tra.rel_attention(*leaves, kv_valid, sm, seed=seed, dropout_rate=rate)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert _counts() == {**before, "rel_attention_fwd": before["rel_attention_fwd"] + 1,
                         "rel_attention_bwd": before["rel_attention_bwd"] + 1}
    ref_out = tra.rel_attention_plain(qu, qv, k, v, p, kv_valid, sm, seed, rate)
    refs = tra.rel_attention_bwd_plain(qu, qv, k, v, p, kv_valid, dout, sm, seed, rate)
    assert (out.float() - ref_out.float()).abs().max().item() <= _rel_attention_tol(ref_out)
    for name, g, r in zip(("dqu", "dqv", "dk", "dv", "dp"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        r = r.to(dtype)
        err = (g.float() - r.float()).abs().max().item()
        assert err <= _grad_tol(r), (name, err, _grad_tol(r))


def _rel_inputs(rng, b, h, t, dk, lengths, dtype, card, logit_scale=1.0):
    qu, qv = (_rand(rng, b, h, t, dk, scale=logit_scale).to(card, dtype) for _ in range(2))
    k, v, dout = (_rand(rng, b, h, t, dk, scale=1.0).to(card, dtype) for _ in range(3))
    p = _rand(rng, h, 2 * t - 1, dk, scale=1.0).to(card, dtype)
    kv_valid = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).to(card, torch.int32)
    return qu, qv, k, v, p, kv_valid, dout


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,lengths", [(1, 312, [312]), (2, 312, [312, 250])])
def test_rel_attention_sharp_softmax(card, b, t, lengths):
    """qu and qv at 3x scale (logits of standard deviation ~4): a product that
    ran on plain TF32 instead of the 3xTF32 split would miss the float32
    forward tolerance by ~300x and the gradients' by ~10x here (the CPU
    emulation in tests/test_torch_rel_tf32.py)."""
    rng = np.random.default_rng(33)
    qu, qv, k, v, p, kv_valid, _ = _rel_inputs(rng, b, 4, t, 64, lengths, torch.float32, card,
                                               logit_scale=3.0)
    out = tra.rel_attention(qu, qv, k, v, p, kv_valid, 0.125)
    ref = tra.rel_attention_plain(qu, qv, k, v, p, kv_valid, 0.125)
    assert (out - ref).abs().max().item() <= _rel_attention_tol(ref)
    _check_rel_backward(card, torch.float32, 0.1, b, 4, t, 64, lengths, logit_scale=3.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [40, 312])
def test_rel_attention_batch_row_with_no_valid_key(card, dtype, t):
    """Every key of the second batch row masked: its scores are all -1e30, so
    each query averages v over all T keys (dropped by the hash), and the
    masked scores pass no gradient, as in the plain version."""
    _check_rel_backward(card, dtype, 0.1, 2, 4, t, 64, [t, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,lengths", [(1, 312, [312]), (1, 937, [937]),
                                         (3, 130, [130, 77, 0])])
def test_rel_attention_is_deterministic(card, dtype, b, t, lengths):
    """Every output element has one owner (the forward's key splits merge in
    a fixed order; dp is summed from per-block partials in a fixed order, no
    atomics): two calls of each entry point are bitwise equal."""
    rng = np.random.default_rng(5)
    qu, qv, k, v, p, kv_valid, dout = _rel_inputs(rng, b, 4, t, 64, lengths, dtype, card)
    args = (qu, qv, k, v, p, kv_valid)
    first = tra.rel_attention_fwd(*args, 0.125, 9, 0.1)
    second = tra.rel_attention_fwd(*args, 0.125, 9, 0.1)
    grads = [tra.rel_attention_bwd(*args, *first, dout, 0.125, 9, 0.1) for _ in range(2)]
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "lse", "dqu", "dqv", "dk", "dv", "dp"),
                          (*first, *grads[0]), (*second, *grads[1])):
        assert torch.equal(x, y), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k_size", [(4, 312, 256, 31), (2, 100, 256, 8), (3, 17, 70, 5)]
                         + DW_CASES + [(64, 312, 256, 31)])  # the last: train-1's shape
def test_depthwise_backward_matches_plain(card, dtype, b, t, c, k_size):
    rng = np.random.default_rng(k_size + 1)
    x = _rand(rng, b, t, c, scale=1.0).to(card, dtype)
    w = _rand(rng, k_size, c, scale=1.0).to(card, dtype).requires_grad_(True)
    dy = _rand(rng, b, t, c, scale=1.0).to(card, dtype)
    xg = x.clone().requires_grad_(True)
    before = _counts()
    dx, dw = torch.autograd.grad(tdw.depthwise_conv1d(xg, w), (xg, w), dy)
    torch.cuda.synchronize()
    assert _counts() == {**before, "dwconv1d_fwd": before["dwconv1d_fwd"] + 1,
                         "dwconv1d_bwd": before["dwconv1d_bwd"] + 1}
    ref_dx, ref_dw = tdw.depthwise_conv1d_bwd_plain(x, w.detach(), dy)
    for g, r in ((dx, ref_dx), (dw, ref_dw)):
        assert g.dtype == dtype and g.shape == r.shape
        assert (g.float() - r.float()).abs().max().item() <= _grad_tol(r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k_size", [(64, 312, 256, 31), (64, 312, 256, 8),
                                          (8, 1874, 256, 31), (3, 17, 70, 5)])
def test_depthwise_backward_is_deterministic(card, dtype, b, t, c, k_size):
    """dw is summed from per-slab partials in a fixed order (no atomics) and
    dx has one owner per element: two calls are bitwise equal."""
    rng = np.random.default_rng(k_size + 2)
    x, dy = (_rand(rng, b, t, c, scale=1.0).to(card, dtype) for _ in range(2))
    w = _rand(rng, k_size, c, scale=1.0).to(card, dtype)
    (dx1, dw1), (dx2, dw2) = (tdw.depthwise_conv1d_bwd(x, w, dy) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(dx1, dx2) and torch.equal(dw1, dw2)


@pytest.mark.gpu
def test_conformer_train_step_on_the_card_matches_the_cpu(card):
    """One fused train step of a 2-block CTC/attention model with mixed
    lengths: the card (kernels forward and backward, one launch of each per
    block) against the CPU (plain versions), same weights and batch, dropout
    off."""
    no_drop = dict(dropout_rate=0.0, positional_dropout_rate=0.0)
    cfg = ASRModelConfig(
        vocab_size=30, frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=40),
        normalize="utterance_mvn",
        encoder=tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=128,
                                      num_blocks=2, macaron_style=True, cnn_module_kernel=15,
                                      attention_dropout_rate=0.0, **no_drop),
        decoder=TransformerDecoderConfig(attention_heads=2, linear_units=128, num_blocks=2,
                                         **no_drop),
        ctc_weight=0.3)
    cpu = init_weights(ASRModel(cfg, device="cpu"), seed=0)
    gpu = ASRModel(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    batch = {"speech": _rand(rng, 3, 20000, scale=0.1),
             "speech_lengths": torch.tensor([20000, 16000, 9000]),
             "text": torch.from_numpy(rng.integers(1, 29, (3, 6))),
             "text_lengths": torch.tensor([6, 4, 5])}
    losses = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        state = init_train_state(model, build_optimizer("adam", {"lr": 1e-3, "eps": 1e-3}))
        step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
        before = _counts()
        stats, _ = step({k: v.to(dev) for k, v in batch.items()})
        if name == "gpu":
            torch.cuda.synchronize()
            assert _counts() == {k: n + (0 if k.startswith(("wkv", "flash")) else 2)
                                 for k, n in before.items()}
        losses[name] = float(stats["loss"])
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    want = cpu.state_dict()
    for name, got in gpu.state_dict().items():
        torch.testing.assert_close(got.cpu(), want[name], rtol=0, atol=1e-5, msg=name)


def _wkv_inputs(rng, b, t, c, k_scale, card):
    w = -torch.exp(_rand(rng, c, scale=0.5)).to(card)
    u = _rand(rng, c, scale=0.5).to(card)
    k = _rand(rng, b, t, c, scale=k_scale).to(card)
    v = _rand(rng, b, t, c, scale=1.0).to(card)
    return w, u, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c,k_scale,given_state", [
    (5, 201, 512, 1.0, False),  # beam-5 serving: the prediction network over u_max + 1
    (1, 313, 512, 1.0, False),  # greedy serving at 10 s of audio
    (16, 25, 512, 1.0, True),   # training, chained from a given state
    (2, 17, 70, 1.0, False),    # C not a multiple of 32
    (1, 1, 33, 1.0, True),      # B = 1, T = 1
    (3, 40, 100, 30.0, True),   # |k| up to ~100: the running maximum carries everything
    # chunk edges (an H100 cuts [1, T, 512] into 16 chunks for 320 <= T < 640,
    # [5, T, 512] into 8 for 128 <= T < 256): T a multiple of the chunk
    # length, one step short of it, one step over it (a last chunk of 6)
    (1, 1, 512, 1.0, False),
    (1, 320, 512, 1.0, False),
    (1, 319, 512, 1.0, True),
    (1, 321, 512, 30.0, False),
    (5, 200, 512, 1.0, True),
    (5, 199, 512, 30.0, False),
    (1, 2000, 512, 1.0, False),  # the most chunks, 32 of 63 steps
    (1, 2000, 512, 30.0, True),
])
def test_wkv_kernel_matches_plain(card, b, t, c, k_scale, given_state):
    """float32, 1e-5: the same formula with expf and IEEE division; the
    kernel's fused multiply-adds and its chunked scan (the carried state
    folded across each earlier chunk) round differently."""
    rng = np.random.default_rng(t + c)
    w, u, k, v = _wkv_inputs(rng, b, t, c, k_scale, card)
    state = None
    if given_state:  # a state carried out of an earlier call, as a chained stream has
        state = twkv.wkv_scan(w, u, *_wkv_inputs(rng, b, 7, c, k_scale, card)[2:])[1]
    before = _counts()
    y, st = twkv.wkv_fwd(w, u, k, v, state)
    torch.cuda.synchronize()
    assert _counts() == {**before, "wkv_fwd": before["wkv_fwd"] + 1}
    ref_y, ref_st = twkv.wkv_scan(w, u, k, v, state)
    torch.testing.assert_close(y, ref_y, rtol=1e-5, atol=1e-5)
    for got, want in zip(st, ref_st):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c,given_state", [
    (5, 201, 512, False), (1, 313, 512, True), (16, 25, 512, False), (1, 2000, 512, True),
])
def test_wkv_forward_is_deterministic(card, b, t, c, given_state):
    """Every output has one owner and the chunk summaries are folded in a
    fixed order (no atomics): two calls are bitwise equal in y and the
    final state."""
    rng = np.random.default_rng(t)
    w, u, k, v = _wkv_inputs(rng, b, t, c, 1.0, card)
    state = twkv.wkv_scan(w, u, *_wkv_inputs(rng, b, 7, c, 1.0, card)[2:])[1] \
        if given_state else None
    n = twkv.chunks(k)
    assert 1 <= n <= 32 and n & (n - 1) == 0 and (n == 1 or -(-t // n) >= 16)
    (y1, s1), (y2, s2) = (twkv.wkv_fwd(w, u, k, v, state) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and all(map(torch.equal, s1, s2))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c,k_scale", [
    (16, 25, 512, 1.0),  # training: the prediction network over U + 1 = 25 labels
    (16, 25, 512, 30.0),
    (16, 101, 512, 1.0),  # the labels of ~40 s of audio: 4 chunks of 26 steps
    (16, 101, 512, 30.0),  # |k| up to ~100 across the chunk folds
    (2, 17, 70, 1.0),
    (1, 1, 33, 1.0),
    (3, 30, 40, 30.0),
    (1, 200, 64, 30.0),  # 8 chunks of 25 steps
    (1, 2000, 512, 1.0),  # 32 chunks of 63 steps, the longest a chunk may be
])
def test_wkv_backward_matches_autograd(card, b, t, c, k_scale):
    """The backward kernel against autograd through the plain loop: every
    gradient at 1e-4 of its largest reference value (the kernel sums over T
    in another order, across chunks through the fold of their summaries,
    and gw, gu over the batch from per-(b, chunk) partials)."""
    rng = np.random.default_rng(b + t + c)
    w, u, k, v = _wkv_inputs(rng, b, t, c, k_scale, card)
    gy = _rand(rng, b, t, c, scale=1.0).to(card)
    leaves = [x.clone().requires_grad_(True) for x in (w, u, k, v)]
    before = _counts()
    y = twkv.wkv(*leaves)
    grads = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    assert _counts() == {**before, "wkv_fwd": before["wkv_fwd"] + 1,
                         "wkv_bwd": before["wkv_bwd"] + 1}
    refs = twkv.wkv_bwd_plain(w, u, k, v, gy)
    for name, g, r in zip(("gw", "gu", "gk", "gv"), grads, refs):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        err = (g - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item() + 1e-6, (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(16, 25, 512), (16, 101, 512), (5, 201, 512), (1, 1, 33)])
def test_wkv_backward_is_deterministic(card, b, t, c):
    """No atomics: gw and gu are per-(b, chunk) partials added in a fixed
    order, so two calls are bitwise equal; the chunk count is the
    forward's, with chunks of at most 64 steps."""
    rng = np.random.default_rng(t + 1)
    w, u, k, v = _wkv_inputs(rng, b, t, c, 1.0, card)
    y, gy = twkv.wkv_fwd(w, u, k, v)[0], _rand(rng, b, t, c, scale=1.0).to(card)
    n = twkv.bwd_chunks(k)
    assert n >= twkv.chunks(k) and -(-t // n) <= 64
    before = _counts()
    first, second = (twkv.wkv_bwd(w, u, k, v, y, gy) for _ in range(2))
    torch.cuda.synchronize()
    assert _counts() == {**before, "wkv_bwd": before["wkv_bwd"] + 2}
    assert all(map(torch.equal, first, second))


@pytest.mark.gpu
def test_wkv_backward_of_no_steps(card):
    """T = 0: the kernel writes gw = gu = 0 and no gk, gv."""
    w, u, k, v = _wkv_inputs(np.random.default_rng(0), 2, 0, 8, 1.0, card)
    gw, gu, gk, gv = twkv.wkv_bwd(w, u, k, v, k, v)
    torch.cuda.synchronize()
    assert gk.shape == (2, 0, 8) and gv.shape == (2, 0, 8)
    assert not gw.any() and not gu.any()


@pytest.mark.gpu
def test_wkv_wrappers_raise_instead_of_falling_back(card):
    w, u, k, v = _wkv_inputs(np.random.default_rng(0), 1, 4, 8, 1.0, card)
    with pytest.raises(TypeError, match="float32"):
        twkv.wkv_fwd(w.double(), u, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        twkv.wkv_fwd(torch.stack([w, w], 1)[:, 0], u, k, v)
    with pytest.raises(ValueError, match="different devices"):
        twkv.wkv_fwd(w, u, k, v.cpu())
    with pytest.raises(ValueError, match="state"):
        twkv.wkv_fwd(w, u, k, v, twkv.wkv_init_state(1, 8))  # a state on the CPU


def _transducer_cfg():
    from llm_guided_asr_tpu_torch.models import transducer as ttd

    no_drop = dict(dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)
    return ttd.TransducerModelConfig(
        vocab_size=30, frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=40),
        normalize="utterance_mvn",
        encoder=tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=128,
                                      num_blocks=2, macaron_style=True, cnn_module_kernel=15,
                                      **no_drop),
        decoder=ttd.TransducerDecoderConfig(decoder_type="rwkv", embed_size=48, hidden_size=48,
                                            num_layers=2),
        joint_size=32, aux_ctc_weight=0.3)


@pytest.mark.gpu
def test_transducer_train_step_on_the_card_matches_the_cpu(card):
    """One fused step of a 2-block Conformer + 2-block RWKV transducer with
    mixed lengths: the card (every kernel forward and backward: one launch
    of each per block) against the CPU (plain versions), same weights and
    batch, dropout off."""
    from llm_guided_asr_tpu_torch.models.transducer import TransducerModel

    cpu = init_weights(TransducerModel(_transducer_cfg(), device="cpu"), seed=0)
    gpu = TransducerModel(_transducer_cfg(), device=card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    batch = {"speech": _rand(rng, 3, 20000, scale=0.1),
             "speech_lengths": torch.tensor([20000, 16000, 9000]),
             "text": torch.from_numpy(rng.integers(1, 29, (3, 6))),
             "text_lengths": torch.tensor([6, 4, 5])}
    losses = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        state = init_train_state(model, build_optimizer("adam", {"lr": 1e-3, "eps": 1e-3}))
        step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
        before = _counts()
        stats, _ = step({k: v.to(dev) for k, v in batch.items()})
        if name == "gpu":
            torch.cuda.synchronize()
            assert _counts() == {k: n + (0 if k.startswith("flash") else 2)
                                 for k, n in before.items()}
        losses[name] = float(stats["loss"])
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    want = cpu.state_dict()
    for name, got in gpu.state_dict().items():
        torch.testing.assert_close(got.cpu(), want[name], rtol=0, atol=1e-5, msg=name)


@pytest.mark.gpu
def test_transducer_decoding_on_the_card_matches_the_cpu(card):
    """Greedy and beam-3 decoding of one utterance: the same tokens, and the
    beam's scores at 1e-4."""
    from llm_guided_asr_tpu_torch.models.transducer import (
        TransducerModel,
        transducer_greedy_decode,
    )
    from llm_guided_asr_tpu_torch.search.transducer_beam import transducer_beam_decode

    cpu = TransducerModel(_transducer_cfg(), device="cpu").eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.normal_(0.0, 0.3)
    gpu = TransducerModel(_transducer_cfg(), device=card).eval()
    gpu.load_state_dict(cpu.state_dict())
    speech = _rand(np.random.default_rng(3), 1, 16000, scale=0.1)
    out = {}
    with torch.no_grad():
        for name, model in (("cpu", cpu), ("gpu", gpu)):
            dev = next(model.parameters()).device
            enc, lens = model.encode(speech.to(dev), torch.tensor([16000], device=dev))
            tok, n = transducer_greedy_decode(model, enc, lens)
            out[name] = (tok[0, : n[0]].tolist(),
                         transducer_beam_decode(model, enc, lens, beam_size=3, nbest=3))
    assert out["gpu"][0] == out["cpu"][0]
    assert [h.yseq for h in out["gpu"][1]] == [h.yseq for h in out["cpu"][1]]
    np.testing.assert_allclose([h.score for h in out["gpu"][1]],
                               [h.score for h in out["cpu"][1]], rtol=1e-4)


# the LSTM recurrence: phase 17's beam-5 prefix, phase 18's training
# labels, a width that leaves the last CTA's slice part empty (the golden
# transducer's 12), one step, and 200 rows at 1024 units (two tiles a
# cluster would not fit: groups run in waves)
LSTM_CASES = [(5, 201, 256), (16, 25, 256), (3, 9, 12), (2, 1, 64), (200, 3, 1024),
              # the (VGG-)RNN encoder's 320 units: after VGG2L (10 s: 250
              # frames) at B = 1 and 64, and without it (1000 frames)
              (1, 250, 320), (64, 250, 320), (1, 1000, 320),
              # the encoders' training shapes of the kernel table (10 s: 312
              # frames after VGG2L; B = 64 takes two tiles a cluster)
              (16, 312, 320), (64, 312, 320),
              # ESPnet's LSTM LM unit, W_hh read from L2
              (16, 50, 650),
              # the multichannel frontend's mask estimator: 64 units over the
              # 1251 STFT frames of 10 s, serving (B = 1) and training (B = 8)
              (1, 1251, 64), (8, 1251, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h", LSTM_CASES)
def test_lstm_kernels_match_plain(card, b, t, h):
    """The forward against the plain loop (1e-5 abs + rel), the backward
    and the autograd function's gradients against autograd through the
    loop (1e-4 of the largest), repeat calls bitwise equal; one launch a
    call."""
    from llm_guided_asr_tpu_torch.ops import lstm as tl

    rng = np.random.default_rng(b * t + h)
    xi = _rand(rng, b, t, 4 * h, scale=0.5).to(card)
    w = _rand(rng, 4 * h, h, scale=1.0 / math.sqrt(h)).to(card)
    bias = _rand(rng, 4 * h, scale=0.1).to(card)
    dy = _rand(rng, b, t, h, scale=1.0).to(card)
    before = dict(tl.KERNEL.launches)
    y, gates, cells = tl.lstm_fwd(xi, w, bias, save=True)
    again = tl.lstm_fwd(xi, w, bias)[0]
    da = tl.lstm_bwd(dy, gates, cells, w)
    torch.cuda.synchronize()
    assert tl.KERNEL.launches == {"lstm_fwd": before["lstm_fwd"] + 2,
                                  "lstm_bwd": before["lstm_bwd"] + 1}
    assert torch.equal(y, again) and torch.equal(da, tl.lstm_bwd(dy, gates, cells, w))
    ref = tl.lstm_recurrence_plain(xi, w, bias)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    leaves = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
    refs = torch.autograd.grad(tl.lstm_recurrence_plain(*leaves), leaves, dy)
    kern = [x.clone().requires_grad_(True) for x in (xi, w, bias)]
    grads = torch.autograd.grad(tl.lstm_recurrence(*kern), kern, dy)
    torch.testing.assert_close(da, refs[0], rtol=0, atol=_grad_tol(refs[0]))
    for name, g, r in zip(("xi", "w_hh", "bias"), grads, refs):
        torch.testing.assert_close(g, r, rtol=0, atol=_grad_tol(r), msg=name)


def multichannel_model_and_batch():
    """A 2-block CTC/attention model (the Transformer encoder: no kernel of
    its own, so that a float64 copy runs on the CPU) behind the
    multichannel frontend (WPE and the MVDR beamformer, a 64-unit BiLSTM
    mask estimator; weights from seed 0) on the CPU in eval mode, a ragged
    batch of 4 channels (one source, each microphone one sample later, plus
    noise) and its config."""
    no_drop = dict(dropout_rate=0.0, positional_dropout_rate=0.0)
    cfg = ASRModelConfig(
        vocab_size=30, frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=40,
                                               use_wpe=True, use_beamformer=True,
                                               mask_units=64, ref_channel=1),
        normalize="utterance_mvn", encoder_type="transformer",
        encoder=tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=128,
                                      num_blocks=2, pos_enc_layer_type="abs_pos",
                                      attention_dropout_rate=0.0, **no_drop),
        decoder=TransformerDecoderConfig(attention_heads=2, linear_units=128, num_blocks=1,
                                         **no_drop),
        ctc_weight=0.3)
    rng = np.random.default_rng(2)
    src = rng.standard_normal(16004) * 0.1
    speech = np.stack([src[4 - c: 16004 - c] + 0.02 * rng.standard_normal(16000)
                       for c in range(4)], axis=1)
    batch = {"speech": torch.from_numpy(np.stack([speech, speech[::-1]]).astype(np.float32)),
             "speech_lengths": torch.tensor([16000, 11000]),
             "text": torch.from_numpy(rng.integers(1, 29, (2, 6))),
             "text_lengths": torch.tensor([6, 4])}
    return init_weights(ASRModel(cfg, device="cpu"), seed=0).eval(), batch, cfg


@pytest.mark.gpu
def test_multichannel_model_on_the_card_matches_the_cpu(card):
    """The model of multichannel_model_and_batch, card against CPU: the
    features (1e-3), the loss (rtol 1e-5) and its gradients (1e-4 of each
    tensor's largest CPU value + 1e-6 of the model's largest; one that
    misses is checked against the CPU's float64 gradient: the card's
    float32 gradient no further from it than the CPU's float32 one, plus
    the tolerance, as the pretrained choices' test below settles them);
    one launch of each LSTM kernel a direction."""
    from llm_guided_asr_tpu_torch.ops import lstm as tl

    cpu, batch, cfg = multichannel_model_and_batch()
    gpu = ASRModel(cfg, device=card).eval()  # the card's float32 policy: TF32 off
    gpu.load_state_dict(cpu.state_dict())
    args = ("speech", "speech_lengths", "text", "text_lengths")
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        before = dict(tl.KERNEL.launches)
        with torch.no_grad():
            feats = model.collect_feats(batch["speech"].to(dev),
                                        batch["speech_lengths"].to(dev))["feats"]
        loss = model(*(batch[k].to(dev) for k in args))[0]
        loss.backward()
        if name == "gpu":
            torch.cuda.synchronize()
            assert tl.KERNEL.launches == {"lstm_fwd": before["lstm_fwd"] + 4,
                                          "lstm_bwd": before["lstm_bwd"] + 2}
        out[name] = (feats.cpu(), loss.item(),
                     {k: p.grad.cpu() for k, p in model.named_parameters()})
    torch.testing.assert_close(out["gpu"][0], out["cpu"][0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["gpu"][1], out["cpu"][1], rtol=1e-5)
    want = out["cpu"][2]
    floor = 1e-6 * max(g.abs().max().item() for g in want.values())
    exact = None
    for name, got in out["gpu"][2].items():
        ref = want[name]
        tol = 1e-4 * ref.abs().max().item() + floor
        if (got - ref).abs().max().item() > tol:
            exact = exact or _float64_grads(cpu, batch, args)
            miss = (got.double() - exact[name]).abs().max().item()
            own = (ref.double() - exact[name]).abs().max().item()
            assert miss <= own + tol, (f"{name}: {miss:.3e} from the float64 gradient > the "
                                       f"CPU's float32 {own:.3e} + {tol:.3e}")


def _fill_shared_kernel():
    from pathlib import Path

    from llm_guided_asr_tpu_torch.ops.cuda_build import CudaKernel

    word, n, ptr = ctypes.c_uint, ctypes.c_int, ctypes.c_void_p
    return CudaKernel(str(Path(__file__).resolve().with_name("cuda") / "fill_shared.cu"),
                      {"fill_shared": [word, n, ptr], "count_shared": [word, n, ptr, ptr]},
                      error_fn="fill_shared_error_string")


# widths whose last CTAs' slices lie part or all past H: the golden
# transducer's 12 (2 CTAs of 8 units) and ESPnet's LSTM LM's 650 (16 of 44)
@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h", [(3, 9, 12), (16, 50, 650)])
def test_lstm_kernels_read_no_stale_shared_memory(card, b, t, h):
    """NaN left in every word of every SM's shared memory just before each
    launch changes no bit of the outputs: the kernels read only shared
    memory they wrote.  The fill is first shown to reach a later kernel."""
    from llm_guided_asr_tpu_torch.ops import lstm as tl

    rng = np.random.default_rng(b * t + h)
    xi = _rand(rng, b, t, 4 * h, scale=0.5).to(card)
    w = _rand(rng, 4 * h, h, scale=1.0 / math.sqrt(h)).to(card)
    bias = _rand(rng, 4 * h, scale=0.1).to(card)
    dy = _rand(rng, b, t, h, scale=1.0).to(card)
    y, gates, cells = tl.lstm_fwd(xi, w, bias, save=True)
    da = tl.lstm_bwd(dy, gates, cells, w)
    fill, nan = _fill_shared_kernel(), 0x7FC00000
    blocks = torch.cuda.get_device_properties(card).multi_processor_count  # one a SM
    count = torch.zeros(1, dtype=torch.int64, device=card)

    def poison():
        with torch.cuda.device(card):
            fill.launch("fill_shared", nan, blocks, torch.cuda.current_stream().cuda_stream)

    poison()
    with torch.cuda.device(card):
        fill.launch("count_shared", nan, blocks, count.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
    assert count.item() == blocks * 232448 // 4
    poison()
    y2, gates2, cells2 = tl.lstm_fwd(xi, w, bias, save=True)
    poison()
    da2 = tl.lstm_bwd(dy, gates, cells, w)
    for got, want in ((y2, y), (gates2, gates), (cells2, cells), (da2, da)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_lstm_wrappers_raise_instead_of_falling_back(card):
    from llm_guided_asr_tpu_torch.ops import lstm as tl

    xi = torch.zeros(2, 3, 32, device=card)
    w, bias = torch.zeros(32, 8, device=card), torch.zeros(32, device=card)
    with pytest.raises(ValueError, match="devices"):
        tl.lstm_fwd(xi, w.cpu(), bias)
    with pytest.raises(ValueError, match="float32"):
        tl.lstm_fwd(xi.double(), w.double(), bias.double())
    with pytest.raises(ValueError, match="CUDA"):
        tl.lstm_bwd(torch.zeros(2, 3, 8), torch.zeros(2, 3, 32), torch.zeros(2, 3, 8),
                    torch.zeros(32, 8))


def _decoder_cfg(decoder_type):
    from llm_guided_asr_tpu_torch.models import transducer as ttd

    if decoder_type == "rnn":
        return ttd.TransducerDecoderConfig(decoder_type="rnn", embed_size=48, hidden_size=64,
                                           num_layers=2)
    return ttd.TransducerDecoderConfig(decoder_type="mega", hidden_size=64, num_layers=2,
                                       mega_qk_size=32, mega_rel_pos_bias="rotary")


@pytest.mark.gpu
@pytest.mark.parametrize("decoder_type", ["rnn", "mega"])
@pytest.mark.parametrize("length", [40, 300])
def test_prediction_networks_on_the_card_match_the_cpu(card, decoder_type, length):
    """The LSTM (one recurrence kernel a layer, forward and backward) and
    MEGA (Toeplitz at 41 positions, rfft past 256) prediction networks:
    outputs at 1e-4, every parameter's gradient at 1e-4 of the largest."""
    from llm_guided_asr_tpu_torch.models.transducer import DECODERS
    from llm_guided_asr_tpu_torch.utils.device import resolve_device

    cfg = _decoder_cfg(decoder_type)
    cpu = init_weights(DECODERS[decoder_type](30, cfg), seed=1)
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.mul_(10.0)
    # as a model's constructor does: float32 products in full precision
    gpu = DECODERS[decoder_type](30, cfg).to(resolve_device(card))
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(length)
    labels = torch.from_numpy(rng.integers(0, 30, (5, length)))
    proj = _rand(rng, 5, length + 1, 64, scale=1.0)
    outs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, card)):
        out = model.eval()(labels.to(dev))
        (out * proj.to(dev)).sum().backward()
        outs[name] = out.detach().cpu()
    torch.testing.assert_close(outs["gpu"], outs["cpu"], rtol=0, atol=1e-4)
    grads = dict(cpu.named_parameters())
    for name, prm in gpu.named_parameters():
        want = grads[name].grad
        torch.testing.assert_close(prm.grad.cpu(), want, rtol=0, atol=_grad_tol(want), msg=name)


@pytest.mark.gpu
def test_multi_blank_loss_on_the_card_matches_the_cpu(card):
    """The multi-blank loss with big blanks of 2, 4 and 8 frames at a
    training-like lattice [4, 60, 13, 40]: the loss at 1e-5, the logits'
    gradient at 1e-4 of the largest."""
    from llm_guided_asr_tpu_torch.ops.rnnt import rnnt_loss_multi_blank

    rng = np.random.default_rng(5)
    logits = _rand(rng, 4, 60, 13, 40, scale=1.0)
    labels = torch.from_numpy(rng.integers(1, 37, (4, 12)))
    tl, ul = torch.tensor([60, 55, 31, 9]), torch.tensor([12, 10, 12, 3])
    out = {}
    for name, dev in (("cpu", "cpu"), ("gpu", card)):
        x = logits.detach().to(dev).requires_grad_(True)
        loss = rnnt_loss_multi_blank(x, labels.to(dev), tl.to(dev), ul.to(dev), 0,
                                     (39, 38, 37), (2, 4, 8), 0.05)
        loss.backward()
        out[name] = (float(loss.detach()), x.grad.cpu())
    np.testing.assert_allclose(out["gpu"][0], out["cpu"][0], rtol=1e-5)
    torch.testing.assert_close(out["gpu"][1], out["cpu"][1], rtol=0,
                               atol=_grad_tol(out["cpu"][1]))


@pytest.mark.gpu
def test_transducer_searches_on_the_card_match_the_cpu(card):
    """An LSTM transducer with two big blanks: every search of
    Speech2Text's transducer_search on the card against the CPU from the
    same encoder rows (tokens equal, scores at 1e-4)."""
    import dataclasses

    from llm_guided_asr_tpu_torch.bin.asr_inference import TRANSDUCER_BEAMS
    from llm_guided_asr_tpu_torch.models.transducer import TransducerModel
    from llm_guided_asr_tpu_torch.search.transducer_extra import transducer_multiblank_greedy

    cfg = dataclasses.replace(_transducer_cfg(), decoder=_decoder_cfg("rnn"),
                              multi_blank_durations=(2, 4))
    cpu = TransducerModel(cfg, device="cpu").eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.normal_(0.0, 0.3)
    gpu = TransducerModel(cfg, device=card).eval()
    gpu.load_state_dict(cpu.state_dict())
    speech = _rand(np.random.default_rng(3), 1, 16000, scale=0.1)
    with torch.no_grad():
        enc, lens = gpu.encode(speech.to(card), torch.tensor([16000], device=card))
    out = {}
    with torch.inference_mode():
        for name, model, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, card)):
            e, n = enc.to(dev), lens.to(dev)
            out[name] = {s: fn(model, e, n, beam_size=3, nbest=3)
                         for s, fn in TRANSDUCER_BEAMS.items()}
            out[name]["mbg"] = transducer_multiblank_greedy(model, e, n, cfg.big_blank_ids,
                                                            cfg.multi_blank_durations)
    for search, hyps in out["gpu"].items():
        want = out["cpu"][search]
        assert [h.yseq for h in hyps] == [h.yseq for h in want], search
        np.testing.assert_allclose([h.score for h in hyps], [h.score for h in want], rtol=1e-4,
                                   err_msg=search)


@pytest.mark.gpu
def test_golden_transducer_on_the_card(card):
    """golden_transducer's tsd, tsd3 and nsc 4-best lists on the card."""
    from llm_guided_asr_tpu_torch.bin import golden_check

    errs = golden_check.run_transducer(card)
    assert max(errs.values()) <= golden_check.TRANSDUCER_SCORE_TOL


# the flash attention kernels: head dims 64, 128 and 256, T not a multiple
# of the 32-row tiles, rows with pads, a batch row of pads only
FLASH_CASES = [
    (1, 4, 1874, 64, [1874]),      # serving, 60 s of audio (T' = 1874)
    (2, 4, 313, 64, [313, 250]),   # two batch rows, one with pads
    (2, 2, 150, 128, [150, 101]),
    (2, 1, 77, 256, [77, 40]),
    (3, 2, 33, 64, [33, 0, 1]),    # a row of pads only, a row with one frame
    # the backward's 64-row tiles at d=64: one row past a tile, a tile of
    # one frame after a full one
    (2, 2, 65, 64, [65, 64]),
    (3, 2, 129, 64, [129, 63, 1]),
    (2, 2, 1874, 128, [1874, 1500]),  # d=128: 32-row tiles, two warps per row block
    # B=1 grids that split the forward's keys over blocks, and ragged tiles
    (1, 2, 16, 64, [16]),
    (1, 2, 17, 64, [17]),
    (1, 2, 31, 64, [31]),
    (1, 4, 1874, 64, [1405]),  # the 45 s request's frames in a 60 s wide batch
    (1, 4, 937, 64, [937]),
]


def _flash_inputs(rng, b, h, t, dk, lengths, dtype, card, qk_scale=1.0):
    q, k = (_rand(rng, b, h, t, dk, scale=qk_scale).to(card, dtype) for _ in range(2))
    v, dout = (_rand(rng, b, h, t, dk, scale=1.0).to(card, dtype) for _ in range(2))
    valid = (torch.arange(t)[None] < torch.tensor(lengths)[:, None]).to(card, torch.int32)
    return q, k, v, dout, valid


def _flash_fwd_tol(ref):
    """float32: 2e-5 of the largest output (the order of the sums over up to
    1874 keys); bfloat16: one unit in the last place of the output, as the
    rel-attention checks."""
    scale = ref.float().abs().max().item()
    return (2e-5 if ref.dtype == torch.float32 else 2.0 ** -7) * scale + 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,dk,lengths", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(card, dtype, b, h, t, dk, lengths):
    rng = np.random.default_rng(t + dk)
    q, k, v, _, valid = _flash_inputs(rng, b, h, t, dk, lengths, dtype, card)
    sm = 1.0 / math.sqrt(dk)
    before = _counts()
    out = tfa.flash_attention(q, k, v, valid, sm)
    out2, lse = tfa.flash_attention_fwd(q, k, v, valid, sm)
    torch.cuda.synchronize()
    assert _counts() == {**before, "flash_attention_fwd": before["flash_attention_fwd"] + 2}
    ref = tfa.flash_attention_plain(q, k, v, valid, sm)
    _, ref_lse = tfa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(), valid.cpu(), sm)
    assert out.dtype == dtype and out.shape == q.shape and torch.equal(out, out2)
    assert (out.float() - ref.float()).abs().max().item() <= _flash_fwd_tol(ref)
    pads = ~valid.bool()[:, None, :, None].expand_as(out)
    assert torch.all(out[pads] == 0)  # pad query rows are exactly 0
    torch.testing.assert_close(lse.cpu(), ref_lse, rtol=1e-5, atol=1e-5)


def _check_flash_backward(card, dtype, b, h, t, dk, lengths, qk_scale=1.0):
    """The kernels under autograd (the forward, then dK/dV and dQ) against
    autograd through the plain version: every gradient at 1e-4 (float32) or
    2**-6 (bfloat16) of its largest reference value; pad query rows get an
    exactly zero dq, masked keys exactly zero dk and dv."""
    rng = np.random.default_rng(t + dk + 1)
    q, k, v, dout, valid = _flash_inputs(rng, b, h, t, dk, lengths, dtype, card, qk_scale)
    sm = 1.0 / math.sqrt(dk)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = _counts()
    out = tfa.flash_attention(*leaves, valid, sm)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert _counts() == {**before, "flash_attention_fwd": before["flash_attention_fwd"] + 1,
                         "flash_attention_bwd_dkv": before["flash_attention_bwd_dkv"] + 1,
                         "flash_attention_bwd_dq": before["flash_attention_bwd_dq"] + 1}
    refs = tfa.flash_attention_bwd_plain(q, k, v, valid, dout, sm)
    pads = ~valid.bool()[:, None, :, None].expand_as(q)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == dtype and g.shape == r.shape, name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= _grad_tol(r), (name, err, _grad_tol(r))
        assert torch.all(g[pads] == 0), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,dk,lengths", FLASH_CASES[1:] + [(8, 4, 313, 64, [313] * 8)])
def test_flash_attention_backward_matches_plain(card, dtype, b, h, t, dk, lengths):
    _check_flash_backward(card, dtype, b, h, t, dk, lengths)


@pytest.mark.gpu
def test_flash_attention_backward_sharp_softmax(card):
    """q and k at 3x scale (logits of standard deviation ~9): a product that
    ran on plain TF32 instead of the 3xTF32 split would miss the float32
    tolerance by 3x to 50x here."""
    _check_flash_backward(card, torch.float32, 1, 4, 1874, 64, [1874], qk_scale=3.0)


@pytest.mark.gpu
def test_flash_attention_forward_sharp_softmax(card):
    """q and k at 3x scale (logits of standard deviation ~9): a product that
    ran on plain TF32 instead of the 3xTF32 split would miss the float32
    forward tolerance here; the lse against the plain logsumexp too."""
    rng = np.random.default_rng(3)
    q, k, v, _, valid = _flash_inputs(rng, 1, 4, 1874, 64, [1874], torch.float32, card, 3.0)
    out, lse = tfa.flash_attention_fwd(q, k, v, valid, 0.125)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_plain(q, k, v, valid, 0.125)
    _, ref_lse = tfa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu(), valid.cpu(), 0.125)
    assert (out - ref).abs().max().item() <= _flash_fwd_tol(ref)
    torch.testing.assert_close(lse.cpu(), ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,t,lengths", [(2, 4, 700, [700, 333]), (1, 4, 1874, [1874])])
def test_flash_attention_forward_is_deterministic(card, dtype, b, h, t, lengths):
    """Every output element has one owner (the key splits of a small grid are
    merged in a fixed order): two calls are bitwise equal in out and lse."""
    rng = np.random.default_rng(8)
    q, k, v, _, valid = _flash_inputs(rng, b, h, t, 64, lengths, dtype, card)
    first = tfa.flash_attention_fwd(q, k, v, valid, 0.125)
    second = tfa.flash_attention_fwd(q, k, v, valid, 0.125)
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "lse"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(card, dtype):
    """Every gradient element has one owner (no atomics): two calls of each
    backward entry point on the same inputs are bitwise equal."""
    b, h, t, dk, lengths = 2, 4, 700, 64, [700, 333]
    rng = np.random.default_rng(7)
    q, k, v, dout, valid = _flash_inputs(rng, b, h, t, dk, lengths, dtype, card)
    out, lse = tfa.flash_attention_fwd(q, k, v, valid, 0.125)
    delta = (out.float() * dout.float()).sum(dim=-1)
    first = (*tfa.flash_attention_bwd_dkv(q, k, v, valid, dout, lse, delta, 0.125),
             tfa.flash_attention_bwd_dq(q, k, v, valid, dout, lse, delta, 0.125))
    second = (*tfa.flash_attention_bwd_dkv(q, k, v, valid, dout, lse, delta, 0.125),
              tfa.flash_attention_bwd_dq(q, k, v, valid, dout, lse, delta, 0.125))
    torch.cuda.synchronize()
    for name, x, y in zip(("dk", "dv", "dq"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.gpu
def test_flash_wrappers_raise_instead_of_falling_back(card):
    valid = torch.ones(1, 4, dtype=torch.int32, device=card)
    q = torch.zeros(1, 2, 4, 32, device=card)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q, valid, 1.0)
    q = torch.zeros(1, 2, 4, 64, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), q.half(), q.half(), valid, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        qt = torch.zeros(1, 4, 2, 64, device=card).transpose(1, 2)
        tfa.flash_attention(qt, qt, qt, valid, 1.0)
    with pytest.raises(ValueError, match="different devices"):
        tfa.flash_attention(q, q, q.cpu(), valid, 1.0)
    with pytest.raises(ValueError, match="16-byte aligned"):  # the kernels copy 16-byte chunks
        qm = torch.zeros(q.numel() + 1, device=card)[1:].view(q.shape)
        tfa.flash_attention(qm, qm, qm, valid, 1.0)


def _flash_asr_cfg():
    no_drop = dict(dropout_rate=0.0, positional_dropout_rate=0.0)
    return ASRModelConfig(
        vocab_size=30, frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=40),
        normalize="utterance_mvn",
        encoder=tconf.ConformerConfig(output_size=128, attention_heads=2, linear_units=128,
                                      num_blocks=2, macaron_style=True, cnn_module_kernel=15,
                                      pos_enc_layer_type="abs_pos",
                                      selfattention_layer_type="flash",
                                      attention_dropout_rate=0.0, **no_drop),
        decoder=TransformerDecoderConfig(attention_heads=2, linear_units=128, num_blocks=2,
                                         **no_drop),
        ctc_weight=0.3)


@pytest.mark.gpu
def test_flash_asr_train_step_on_the_card_matches_the_cpu(card):
    """One fused step of a 2-block flash/abs_pos CTC/attention model (head
    dim 64) with mixed lengths: the card (the flash and depthwise kernels
    forward and backward, one launch of each entry point per block, no
    rel-attention) against the CPU (plain versions)."""
    cpu = init_weights(ASRModel(_flash_asr_cfg(), device="cpu"), seed=0)
    gpu = ASRModel(_flash_asr_cfg(), device=card)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    batch = {"speech": _rand(rng, 3, 20000, scale=0.1),
             "speech_lengths": torch.tensor([20000, 16000, 9000]),
             "text": torch.from_numpy(rng.integers(1, 29, (3, 6))),
             "text_lengths": torch.tensor([6, 4, 5])}
    losses = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        state = init_train_state(model, build_optimizer("adam", {"lr": 1e-3, "eps": 1e-3}))
        step = make_fused_train_step(model, state, torch.Generator().manual_seed(0))
        before = _counts()
        stats, _ = step({k: v.to(dev) for k, v in batch.items()})
        if name == "gpu":
            torch.cuda.synchronize()
            assert _counts() == {k: n + (2 if k.startswith(("flash", "dwconv")) else 0)
                                 for k, n in before.items()}
        losses[name] = float(stats["loss"])
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    want = cpu.state_dict()
    for name, got in gpu.state_dict().items():
        torch.testing.assert_close(got.cpu(), want[name], rtol=0, atol=1e-5, msg=name)


@pytest.mark.gpu
def test_flash_asr_decoding_on_the_card_matches_the_cpu(card):
    """Beam-3 Speech2Text of one utterance with the stateless scorer: the
    same tokens and scores at 1e-4 on the card and on the CPU, and the
    encoder at 1e-4."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    cpu = ASRModel(_flash_asr_cfg(), device="cpu").eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.normal_(0.0, 0.1)
    gpu = ASRModel(_flash_asr_cfg(), device=card).eval()
    gpu.load_state_dict(cpu.state_dict())
    speech = _rand(np.random.default_rng(5), 1, 24000, scale=0.1)
    out, enc = {}, {}
    with torch.no_grad():
        for name, model in (("cpu", cpu), ("gpu", gpu)):
            dev = next(model.parameters()).device
            enc[name] = model.encode(speech.to(dev), torch.tensor([24000], device=dev))[0].cpu()
            out[name] = Speech2Text.from_model(model, beam_size=3, nbest=3,
                                               maxlenratio=-8.0)(speech[0].numpy())
    torch.testing.assert_close(enc["gpu"], enc["cpu"], rtol=1e-4, atol=1e-4)
    assert [ids for ids, _ in out["gpu"]] == [ids for ids, _ in out["cpu"]]
    np.testing.assert_allclose([h.score for _, h in out["gpu"]],
                               [h.score for _, h in out["cpu"]], rtol=1e-4)


@pytest.mark.gpu
def test_golden_fixtures_on_the_card(card):
    """The reference's golden fixtures (tests/parity/) at the JAX parity
    tests' tolerances, with the encoders on the rel-pos and depthwise
    forward kernels at head dim 16 and conv kernel 7: 3 encoder passes of 2
    blocks for the random-weight fixtures, one per utterance of the
    30-utterance tone corpus for golden_trained_guided, and for
    golden_trained one per utterance offline, one with the LM and one for
    each of the 8 streamed utterances; nothing else launched."""
    from llm_guided_asr_tpu_torch.bin import golden_check

    before = _counts()
    golden_check.run_all(card)
    torch.cuda.synchronize()
    after = _counts()
    launched = {k: after[k] - before[k] for k in after}
    want = 2 * (3 + 30 + 30 + 30 + golden_check.N_STREAMED)
    assert launched == {k: want if k in ("rel_attention_fwd", "dwconv1d_fwd") else 0
                        for k in after}


@pytest.mark.gpu
def test_batched_guided_decoding_on_the_card_matches_single(card):
    """A tiny float32 LLM-guided model on the card: Speech2Text.batch_call of
    three ragged requests (one encode: one launch of each encoder forward
    kernel a block) and each lane decoded alone from the same encoder rows
    give the same tokens, scores within 1e-4."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.models import llm_guided as tlg
    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
    from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate

    cfg = tlg.LLMGuidedASRConfig(
        vocab_size=50, llm=LlamaConfig(vocab_size=50, hidden_size=32, intermediate_size=48,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       num_key_value_heads=2),
        prompt=PromptTemplate(prefix_ids=(2, 3, 4), suffix_ids=(5, 6), start_of_response_id=7,
                              end_of_response_id=7, pad_id=0),
        frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=23), normalize="utterance_mvn",
        encoder=tconf.ConformerConfig(output_size=32, attention_heads=2, linear_units=64,
                                      num_blocks=2, macaron_style=True, cnn_module_kernel=7),
        decoder=TransformerDecoderConfig(attention_heads=2, linear_units=64, num_blocks=2),
        ctc_weight=0.3)
    model = init_weights(tlg.LLMGuidedASRModel(cfg, llm_dtype=torch.float32, device=card), 0)
    with torch.no_grad():
        for prm in model.parameters():
            prm.mul_(20.0)  # peaked distributions: hypotheses of several tokens
    rng = np.random.default_rng(3)
    waves = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (9600, 6400, 3200)]
    s2t = Speech2Text.from_model(model.eval(), ctc_weight=0.3, beam_size=4, nbest=2,
                                 maxlenratio=-8.0)
    before = _counts()
    batched = s2t.batch_call(waves)
    torch.cuda.synchronize()
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 if k in ("rel_attention_fwd", "dwconv1d_fwd") else 0 for k in after}
    batch = np.zeros((3, 9600), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    with torch.no_grad():
        enc, lens = model.encode(torch.from_numpy(batch).to(card),
                                 torch.tensor([len(w) for w in waves], device=card))
    for b, got in enumerate(batched):
        alone = s2t.beam(enc[b:b + 1], lens[b:b + 1], maxlenratio=-8.0, nbest=2)
        assert [ids for ids, _ in got] == [[t for t in h.yseq if t != 7] for h in alone]
        np.testing.assert_allclose([h.score for _, h in got], [h.score for h in alone],
                                   atol=1e-4)
    assert any(len(r[0][0]) > 2 for r in batched)


@pytest.mark.gpu
def test_transformer_lm_on_the_card_matches_the_cpu(card):
    """The LM's score function (the beam search's full scorer) over a batch
    of prefixes: the card (cuBLAS, float32 with TF32 off) against the CPU,
    1e-4."""
    from llm_guided_asr_tpu_torch.models.lm import (
        TransformerLM,
        TransformerLMConfig,
        make_lm_score_fn,
    )

    cfg = TransformerLMConfig(vocab_size=500, embed_unit=32, att_unit=64, head=4, unit=128,
                              layer=2, dropout_rate=0.0)
    cpu = init_weights(TransformerLM(cfg, device="cpu"), 0).eval()
    gpu = TransformerLM(cfg, device=card).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, 500, (10, 26)))
    lens = torch.from_numpy(rng.integers(1, 27, 10))
    with torch.no_grad():
        want = make_lm_score_fn(cpu)(tokens, lens)
        got = make_lm_score_fn(gpu)(tokens.to(card), lens.to(card))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_streamed_encoder_on_the_card_matches_the_offline_encoder(card):
    """The contextual-block Conformer fed block by block (encode_chunk with
    the carried contexts) equals its offline pass on the card (1e-5); one
    depthwise launch a block a layer and no rel-pos launch; and the card
    against the CPU (1e-4)."""
    cfg = tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=128,
                                num_blocks=2, macaron_style=True, cnn_module_kernel=15,
                                block_size=8)
    torch.manual_seed(0)
    cpu = tconf.make_encoder("contextual_block_conformer", cfg, 40, device="cpu").eval()
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.normal_(0.0, 0.1)
    gpu = tconf.make_encoder("contextual_block_conformer", cfg, 40, device=card).eval()
    gpu.load_state_dict(cpu.state_dict())
    feats = _rand(np.random.default_rng(5), 1, 4 * 24 + 6, 40, scale=1.0)
    before = _counts()
    with torch.no_grad():
        offline, _ = gpu(feats.to(card), torch.tensor([feats.shape[1]], device=card))
        torch.cuda.synchronize()
        after = _counts()
        ctxs, rows = torch.zeros(2, 1, 64, device=card), []
        for blk in range(3):
            chunk = feats[:, 32 * blk: 32 * (blk + 1) + 6].to(card)
            out, ctxs = gpu.encode_chunk(chunk, ctxs, 8 * blk, 8)
            rows.append(out)
        want_cpu, _ = cpu(feats, torch.tensor([feats.shape[1]]))
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * 3 if k == "dwconv1d_fwd" else 0 for k in after}  # 24 sub-frames: 3 blocks
    torch.testing.assert_close(torch.cat(rows, 1), offline[:, :24], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(offline.cpu(), want_cpu, rtol=1e-4, atol=1e-4)


OPTAX_OPTIMIZERS = ("sgd", "adadelta", "adagrad", "rmsprop", "radam", "lamb", "adafactor",
                    "lion")


@pytest.mark.gpu
@pytest.mark.parametrize("name", OPTAX_OPTIMIZERS)
def test_optax_optimizer_update_on_the_card_matches_the_cpu(card, name):
    """Eight updates (clip 5, warmuplr, radam past its rectification) of
    the same seeded gradients on the card and on the CPU; a 128 x 160 leaf
    makes adafactor factor.  float32: only the order of the reductions
    (norms, adafactor's means) differs: 1e-5 relative, 1e-6 absolute."""
    from llm_guided_asr_tpu_torch.train.trainer import apply_update

    rng = np.random.default_rng(0)
    shapes = {"a": (128, 160), "b": (7, 5), "c": (11,)}
    values = {k: _rand(rng, *s, scale=0.5) for k, s in shapes.items()}
    grads = [{k: _rand(rng, *s, scale=0.5) for k, s in shapes.items()} for _ in range(8)]
    conf = {"lr": 1.0 if name == "adadelta" else 1e-2}
    conf.update({"sgd": {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01},
                 "rmsprop": {"momentum": 0.9}, "lamb": {"weight_decay": 0.01},
                 "lion": {"weight_decay": 0.01}}.get(name, {}))
    out = {}
    for dev in ("cpu", card):
        model = torch.nn.Module()
        for k, v in values.items():
            setattr(model, k, torch.nn.Parameter(v.clone().to(dev)))
        state = init_train_state(model, build_optimizer(
            name, dict(conf), scheduler="warmuplr", scheduler_conf={"warmup_steps": 3}))
        for g in grads:
            for k, p in model.named_parameters():
                p.grad = g[k].to(dev)
            assert apply_update(state)
        out[str(dev)] = {k: p.detach().cpu() for k, p in model.named_parameters()}
    for k in shapes:
        torch.testing.assert_close(out["cuda"][k], out["cpu"][k], rtol=1e-5, atol=1e-6,
                                   msg=f"{name} {k}")


@pytest.mark.gpu
def test_trainer_run_on_the_card_matches_the_cpu(card, tmp_path):
    """A tiny ASRModel (2 x 64, dropout 0, intermediate CTC on block 1)
    trained by Trainer.run for 2 epochs of 3 microbatches at accum_grad 2
    on both devices from the same weights: every reporter stat but the
    timings within 1e-3 relative (F.ctc_loss's CUDA backward sums in no
    fixed order; four Adam updates), the weights within 1e-4."""
    from llm_guided_asr_tpu_torch.train.reporter import Reporter
    from llm_guided_asr_tpu_torch.train.trainer import Trainer, TrainerOptions

    cfg = ASRModelConfig(
        vocab_size=30, frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=40),
        normalize="utterance_mvn",
        encoder=tconf.ConformerConfig(output_size=64, attention_heads=1, linear_units=128,
                                      num_blocks=2, macaron_style=True, cnn_module_kernel=15,
                                      dropout_rate=0.0, positional_dropout_rate=0.0,
                                      interctc_layer_idx=(1,)),
        decoder=TransformerDecoderConfig(attention_heads=2, linear_units=128, num_blocks=2,
                                         dropout_rate=0.0, positional_dropout_rate=0.0),
        ctc_weight=0.3, interctc_weight=0.3)
    rng = np.random.default_rng(2)
    batches = [{"speech": _rand(rng, 3, 20000, scale=0.1),
                "speech_lengths": torch.tensor([20000, 16000, 9000]),
                "text": torch.from_numpy(rng.integers(1, 29, (3, 6))),
                "text_lengths": torch.tensor([6, 4, 5])} for _ in range(4)]
    cpu = init_weights(ASRModel(cfg, device="cpu"), seed=0)
    gpu = ASRModel(cfg, device=card)
    gpu.load_state_dict(cpu.state_dict())
    stats = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        on = [{k: v.to(dev) for k, v in b.items()} for b in batches]
        Trainer.run(model, build_optimizer("adam", {"lr": 1e-3, "eps": 1e-3}),
                    lambda e: on[:3], lambda e: on[3:], tmp_path / name,
                    TrainerOptions(max_epoch=2, accum_grad=2, log_interval=2,
                                   keep_nbest_models=1))
        stats[name] = Reporter.load(tmp_path / name / "reporter.json").stats
    timing = {"time", "iter_time", "grad_time", "optim_step_time", "train_step_time"}
    for e in (1, 2):
        for phase in ("train", "valid"):
            for k, v in stats["cpu"][e][phase].items():
                if k not in timing:
                    np.testing.assert_allclose(stats["gpu"][e][phase][k], v, rtol=1e-3,
                                               err_msg=f"{e} {phase} {k}")
    want = cpu.state_dict()
    for name, got in gpu.state_dict().items():
        torch.testing.assert_close(got.cpu(), want[name], rtol=0, atol=1e-4, msg=name)


# ---- the task and CLI layer on the card (chip_smoke.py phase 16 at tiny widths) ----

CLI_ENC = {"output_size": 64, "attention_heads": 1, "linear_units": 128, "num_blocks": 2,
           "macaron_style": True, "cnn_module_kernel": 15, "dropout_rate": 0.0,
           "positional_dropout_rate": 0.0}
CLI_DEC = {"attention_heads": 2, "linear_units": 128, "num_blocks": 2, "dropout_rate": 0.0,
           "positional_dropout_rate": 0.0}
CLI_TIMING = {"time", "iter_time", "grad_time", "optim_step_time", "train_step_time"}


@pytest.fixture(scope="module")
def cli_corpus(tmp_path_factory):
    """6 + 2 wav files of seeded noise (0.5-1.2 s) with letter texts, a char
    token list, and the tiny CTC/attention config."""
    from llm_guided_asr_tpu_torch.data.fileio import write_wav
    from llm_guided_asr_tpu_torch.utils.config import dump_yaml

    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(16)
    for split, n in (("train", 6), ("valid", 2)):
        with open(root / f"{split}.scp", "w") as scp, open(root / f"{split}.txt", "w") as txt:
            for i in range(n):
                path = root / f"{split}{i}.wav"
                write_wav(path, 16000, (rng.standard_normal(int(rng.integers(8000, 19200)))
                                        * 0.1).astype(np.float32))
                scp.write(f"{split}{i} {path}\n")
                txt.write(f"{split}{i} {''.join(rng.choice(list('abcde'), 4))}\n")
    (root / "tokens.txt").write_text("\n".join(["<blank>", "<unk>", *"abcde", "<sos/eos>"]))
    config = {
        "token_list": str(root / "tokens.txt"),
        "frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 40},
        "encoder_conf": CLI_ENC, "decoder_conf": CLI_DEC, "model_conf": {"ctc_weight": 0.3},
        "optim": "adam", "optim_conf": {"lr": 1.0e-3, "eps": 1.0e-3},
        "batch_type": "sorted", "batch_size": 3, "max_epoch": 1, "keep_nbest_models": 1,
        "train_data_path_and_name_and_type": [[str(root / "train.scp"), "speech", "sound"],
                                              [str(root / "train.txt"), "text", "text"]],
        "valid_data_path_and_name_and_type": [[str(root / "valid.scp"), "speech", "sound"],
                                              [str(root / "valid.txt"), "text", "text"]],
    }
    dump_yaml(config, root / "train.yaml")
    return root


def _cli_decode(root, exp, model_file, out, device, *extra):
    from llm_guided_asr_tpu_torch.bin import asr_inference

    asr_inference.main(["--asr_train_config", str(exp / "config.yaml"), "--asr_model_file",
                        str(model_file), "--data_path_and_name_and_type",
                        f"{root / 'valid.scp'},speech,sound", "--output_dir", str(out),
                        "--device", device, "--beam_size", "4", "--ctc_weight", "0.3",
                        "--maxlenratio", "-8"]
                       + list(extra))
    from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text

    return {name: read_2columns_text(out / "1best_recog" / name)
            for name in ("token", "score", "score_decoder", "score_ctc")}


def _cli_same_decodes(got, want, tol=1e-3):
    assert got["token"] == want["token"]
    for name in ("score", "score_decoder", "score_ctc"):
        for uid, v in want[name].items():
            assert abs(float(got[name][uid]) - float(v)) <= tol, (name, uid)


@pytest.mark.gpu
def test_asr_cli_on_the_card_matches_the_cpu(card, cli_corpus, tmp_path):
    """Part A at tiny widths: collect_stats on both devices (rtol 1e-4), one
    epoch of asr_train from the same init_param file on both (reporter
    stats within 1e-3 relative; 2 forward launches of each encoder kernel a
    microbatch and a validation batch, 2 backward a microbatch), and the
    CPU run's checkpoint decoded by asr_inference on both devices (tokens
    equal, scores within 1e-3)."""
    from llm_guided_asr_tpu_torch.bin import asr_train
    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask, build_model, init_model_variables
    from llm_guided_asr_tpu_torch.train.reporter import Reporter
    from llm_guided_asr_tpu_torch.utils.config import load_yaml

    root = cli_corpus
    for dev in ("cpu", "cuda"):
        asr_train.main(["--config", str(root / "train.yaml"), "--collect_stats", "true",
                        "--output_dir", str(tmp_path / f"stats_{dev}"), "--device", dev])
    for k in ("count", "sum", "sum_square"):
        np.testing.assert_allclose(np.load(tmp_path / "stats_cuda/train/feats_stats.npz")[k],
                                   np.load(tmp_path / "stats_cpu/train/feats_stats.npz")[k],
                                   rtol=1e-4, err_msg=k)
    stats_file = tmp_path / "stats_cpu" / "train" / "feats_stats.npz"
    config = {**ASRTask.get_default_config(), **load_yaml(root / "train.yaml")}
    init = init_model_variables(build_model(config, "cpu"), config)
    torch.save(init.state_dict(), tmp_path / "init.pth")
    stats = {}
    for dev in ("cpu", "cuda"):
        tra.KERNEL.reset_launches()
        tdw.KERNEL.reset_launches()
        asr_train.main(["--config", str(root / "train.yaml"), "--output_dir",
                        str(tmp_path / dev), "--device", dev, "--normalize_conf",
                        f"stats_file={stats_file}", "--init_param",
                        f"[{tmp_path / 'init.pth'}]"])
        stats[dev] = Reporter.load(tmp_path / dev / "reporter.json").stats[1]
        if dev == "cuda":
            c = _counts()  # 2 train microbatches and 1 validation batch, 2 blocks
            assert (c["rel_attention_fwd"], c["dwconv1d_fwd"]) == (6, 6), c
            assert (c["rel_attention_bwd"], c["dwconv1d_bwd"]) == (4, 4), c
    for phase in ("train", "valid"):
        for k, v in stats["cpu"][phase].items():
            if k not in CLI_TIMING:
                np.testing.assert_allclose(stats["cuda"][phase][k], v, rtol=1e-3,
                                           err_msg=f"{phase} {k}")
    ckpt = tmp_path / "cpu" / "valid.loss.ave_1best.pth"
    want = _cli_decode(root, tmp_path / "cpu", ckpt, tmp_path / "dec_cpu", "cpu")
    got = _cli_decode(root, tmp_path / "cpu", ckpt, tmp_path / "dec_cuda", "cuda")
    _cli_same_decodes(got, want)


@pytest.mark.gpu
def test_guided_and_lm_clis_on_the_card(card, cli_corpus, tmp_path):
    """Parts B and C at tiny widths: the guided config over
    tests/parity/tiny_llm_bpe trained one epoch on the card (no LLM tensor
    in any .pth) and decoded on both devices; a tiny TransformerLM trained
    on the card, its perplexity on both devices (1e-4 relative), and a
    decode with it at lm_weight 0.3 (score = 0.7 decoder + 0.3 ctc + 0.3 lm)."""
    from pathlib import Path

    from llm_guided_asr_tpu_torch.bin import asr_train, lm_calc_perplexity, lm_train
    from llm_guided_asr_tpu_torch.train.checkpoint import load
    from llm_guided_asr_tpu_torch.utils.config import dump_yaml, load_yaml

    root = cli_corpus
    llm_dir = Path(__file__).resolve().parent / "parity" / "tiny_llm_bpe"
    guided = {**load_yaml(root / "train.yaml"), "model": "llm_guided_asr",
              "token_type": "hugging_face", "token_list": None, "normalize": "utterance_mvn",
              "llm_conf": {"model_name_or_path": str(llm_dir),
                           "template_prompt": 'fix "((HYP))" -> "', "pad_token": "<pad>"}}
    dump_yaml(guided, tmp_path / "guided.yaml")
    asr_train.main(["--config", str(tmp_path / "guided.yaml"), "--output_dir",
                    str(tmp_path / "g")])
    for path in (tmp_path / "g").glob("*.pth"):
        obj = load(path)
        assert not any(k.startswith("llm.") for k in obj.get("model", obj)), path
    ckpt = tmp_path / "g" / "valid.loss.ave_1best.pth"
    _cli_same_decodes(_cli_decode(root, tmp_path / "g", ckpt, tmp_path / "gd_cuda", "cuda"),
                      _cli_decode(root, tmp_path / "g", ckpt, tmp_path / "gd_cpu", "cpu"))

    dump_yaml({"token_list": str(root / "tokens.txt"), "lm": "transformer",
               "lm_conf": {"embed_unit": 16, "att_unit": 32, "head": 2, "unit": 32, "layer": 2,
                           "dropout_rate": 0.0}, "max_epoch": 1, "keep_nbest_models": 1,
               "train_data_path_and_name_and_type": [[str(root / "train.txt"), "text", "text"]],
               "valid_data_path_and_name_and_type": [[str(root / "valid.txt"), "text", "text"]]},
              tmp_path / "lm.yaml")
    lm_train.main(["--config", str(tmp_path / "lm.yaml"), "--output_dir", str(tmp_path / "lm")])
    lm_file = tmp_path / "lm" / "valid.loss.ave_1best.pth"
    ppl = {dev: lm_calc_perplexity.main([
        "--train_config", str(tmp_path / "lm" / "config.yaml"), "--model_file", str(lm_file),
        "--data_path_and_name_and_type", f"{root / 'valid.txt'},text,text", "--device", dev])
        for dev in ("cpu", "cuda")}
    assert math.isfinite(ppl["cuda"]) and abs(ppl["cuda"] - ppl["cpu"]) <= 1e-4 * ppl["cpu"]
    asr_train.main(["--config", str(root / "train.yaml"), "--output_dir", str(tmp_path / "a")])
    got = _cli_decode(root, tmp_path / "a", tmp_path / "a" / "valid.loss.ave_1best.pth",
                      tmp_path / "ld", "cuda", "--lm_train_config",
                      str(tmp_path / "lm" / "config.yaml"), "--lm_file", str(lm_file),
                      "--lm_weight", "0.3")
    from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text

    lm_part = read_2columns_text(tmp_path / "ld" / "1best_recog" / "score_lm")
    for uid, total in got["score"].items():
        want = (0.7 * float(got["score_decoder"][uid]) + 0.3 * float(got["score_ctc"][uid])
                + 0.3 * float(lm_part[uid]))
        assert abs(float(total) - want) <= 1e-3 * max(1.0, abs(want)), uid


@pytest.mark.gpu
def test_st_model_on_the_card_matches_the_cpu(card):
    """The LLM-guided ST model (a tiny LLM, source vocabulary the LLM's,
    an extra ASR decoder) on the card against the CPU plain path: the loss
    and every stats term (rtol 1e-4), every trainable gradient (1e-4 of
    the largest), and Speech2Translation's 3-best (tokens equal, scores
    1e-4); the rel-pos and depthwise kernels launch on the card."""
    from llm_guided_asr_tpu_torch.bin.st_inference import Speech2Translation
    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
    from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
    from llm_guided_asr_tpu_torch.models.llm_guided_st import LLMGuidedSTConfig, LLMGuidedSTModel
    from llm_guided_asr_tpu_torch.tasks.st import ST_BATCH_ARGS

    dec = TransformerDecoderConfig(attention_heads=2, linear_units=64, num_blocks=2,
                                   dropout_rate=0.0)
    cfg = LLMGuidedSTConfig(
        vocab_size=300, src_vocab_size=300,
        llm=LlamaConfig(vocab_size=300, hidden_size=32, intermediate_size=48,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2),
        prompt=PromptTemplate(prefix_ids=(2, 3, 4), suffix_ids=(5, 6), start_of_response_id=7,
                              end_of_response_id=7, pad_id=0),
        frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=23), normalize="utterance_mvn",
        encoder=tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=128,
                                      num_blocks=2, cnn_module_kernel=15),
        decoder=dec, extra_asr_decoder=dec, lsm_weight=0.1)
    cpu = init_weights(LLMGuidedSTModel(cfg, llm_dtype=torch.float32, device="cpu"), 3).eval()
    gpu = LLMGuidedSTModel(cfg, llm_dtype=torch.float32, device=card).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(9)
    batch = {"speech": _rand(rng, 2, 12000, scale=0.1), "speech_lengths": torch.tensor([12000, 8000]),
             "text": torch.from_numpy(rng.integers(10, 300, (2, 5))),
             "text_lengths": torch.tensor([5, 3]),
             "src_text": torch.from_numpy(rng.integers(10, 300, (2, 7))),
             "src_text_lengths": torch.tensor([7, 4])}
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        model.zero_grad(set_to_none=True)
        loss, stats, _ = model(*(batch[k].to(dev) for k in ST_BATCH_ARGS))
        loss.backward()
        out[name] = ({k: float(v) for k, v in stats.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None})
    for k, v in out["cpu"][0].items():
        assert abs(out["gpu"][0][k] - v) <= 1e-4 * max(1.0, abs(v)), k
    assert out["gpu"][1].keys() == out["cpu"][1].keys()
    assert not any(n.startswith("llm.") for n in out["cpu"][1])
    for n, ref in out["cpu"][1].items():
        torch.testing.assert_close(out["gpu"][1][n], ref, rtol=0, atol=_grad_tol(ref), msg=n)
    before = _counts()
    wave = batch["speech"][0].numpy()
    got = {name: Speech2Translation.from_model(model, beam_size=3, nbest=3, maxlenratio=-12.0)(wave)
           for name, model in (("cpu", cpu), ("gpu", gpu))}
    after = _counts()
    assert after["rel_attention_fwd"] - before["rel_attention_fwd"] == 2
    assert after["dwconv1d_fwd"] - before["dwconv1d_fwd"] == 2
    assert [ids for ids, _ in got["gpu"]] == [ids for ids, _ in got["cpu"]]
    np.testing.assert_allclose([h.score for _, h in got["gpu"]],
                               [h.score for _, h in got["cpu"]], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ebranchformer_on_the_card_matches_the_cpu(card):
    """Two E-Branchformer blocks with mixed lengths, forward and backward:
    the card (kernels) against the CPU (plain versions), one launch of each
    encoder kernel entry point per block."""
    from llm_guided_asr_tpu_torch.models.branchformer import EBranchformerEncoder

    cfg = tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=256,
                                num_blocks=2, cnn_module_kernel=31, dropout_rate=0.0,
                                positional_dropout_rate=0.0)
    torch.manual_seed(0)
    cpu = EBranchformerEncoder(cfg, 40, device="cpu").train()
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.normal_(0.0, 0.1)
    gpu = EBranchformerEncoder(cfg, 40, device=card).train()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    feats = _rand(rng, 3, 157, 40, scale=1.0)
    lengths = torch.tensor([157, 120, 61])
    r = _rand(rng, 3, 38, 64, scale=1.0)
    grads = {}
    before = _counts()
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        out, lens = model(feats.to(dev), lengths.to(dev))
        (out * r.to(dev)).sum().backward()
        grads[name] = (out.detach().cpu(), lens.cpu(),
                       {n: q.grad.cpu() for n, q in model.named_parameters()})
    torch.cuda.synchronize()
    assert _counts() == {**before, **{k: before[k] + 2 for k in (
        "rel_attention_fwd", "rel_attention_bwd", "dwconv1d_fwd", "dwconv1d_bwd")}}
    assert torch.equal(grads["gpu"][1], grads["cpu"][1])
    torch.testing.assert_close(grads["gpu"][0], grads["cpu"][0], rtol=1e-4, atol=1e-4)
    for n, ref in grads["cpu"][2].items():
        torch.testing.assert_close(grads["gpu"][2][n], ref, rtol=0, atol=_grad_tol(ref), msg=n)


@pytest.mark.gpu
def test_brctc_on_the_card_matches_the_cpu(card):
    """The Bayes-risk CTC (risk 0.1) at a ragged batch with an infeasible
    example: loss and logits gradient on the card against the CPU, the
    gradient within twice the builtin CTC's own card-vs-CPU difference
    plus 1e-5 (F.ctc_loss's float32 log-space lattice rounds the
    posteriors on both paths, by more the longer the input)."""
    from llm_guided_asr_tpu_torch.ops.losses import ctc_loss_per_example

    rng = np.random.default_rng(3)
    logits = _rand(rng, 4, 120, 50, scale=2.0)
    lengths = torch.tensor([120, 97, 60, 3])
    labels = torch.from_numpy(rng.integers(1, 50, (4, 30)))
    labels[3, :3] = torch.tensor([2, 2, 3])
    label_lengths = torch.tensor([30, 22, 17, 3])
    out = {}
    for risk in (0.1, 0.0):
        for dev in ("cpu", card):
            x = logits.to(dev).detach().requires_grad_(True)
            per_ex = ctc_loss_per_example(x, lengths.to(dev), labels.to(dev),
                                          label_lengths.to(dev), time_risk=risk)
            per_ex.sum().backward()
            out[(risk, str(dev))] = (per_ex.detach().cpu(), x.grad.cpu())
    got, want = out[(0.1, "cuda")], out[(0.1, "cpu")]
    assert float(got[0][3]) == 0.0 and not got[1][3].any()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    builtin_err = (out[(0.0, "cuda")][1] - out[(0.0, "cpu")][1]).abs().max().item()
    assert (got[1] - want[1]).abs().max().item() <= 2.0 * builtin_err + 1e-5


def _card_vs_cpu(card, build, feats, lengths, r_shape, train=True):
    """A module built by ``build(device)`` on the CPU (weights N(0, 0.1))
    and on the card with the same weights: outputs, lengths and, when
    ``train``, every gradient of sum(out * r); returns the launch counts
    the card's pass added."""
    torch.manual_seed(0)
    cpu = build("cpu").train(train)
    with torch.no_grad():
        for prm in cpu.parameters():
            prm.normal_(0.0, 0.1)
    gpu = build(card).train(train)
    gpu.load_state_dict(cpu.state_dict())
    r = _rand(np.random.default_rng(1), *r_shape, scale=1.0)
    got = {}
    from llm_guided_asr_tpu_torch.ops import lstm as tl

    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        before = {**_counts(), **tl.KERNEL.launches}
        with torch.set_grad_enabled(train):
            out = model(*(x.to(dev) for x in feats))
            out, lens = out if isinstance(out, tuple) else (out, lengths)
            if train:
                (out * r.to(dev)).sum().backward()
        torch.cuda.synchronize()
        after = {**_counts(), **tl.KERNEL.launches}
        got[name] = (out.detach().cpu(), lens.cpu(), {k: after[k] - before[k] for k in after},
                     {n: q.grad.cpu() for n, q in model.named_parameters()} if train else {})
    assert not any(got["cpu"][2].values())
    assert torch.equal(got["gpu"][1], got["cpu"][1])
    torch.testing.assert_close(got["gpu"][0], got["cpu"][0], rtol=1e-4, atol=1e-4)
    for n, ref in got["cpu"][3].items():
        torch.testing.assert_close(got["gpu"][3][n], ref, rtol=0, atol=_grad_tol(ref), msg=n)
    return got["gpu"][2]


# encoder type -> (encoder_conf beyond the common one, the launches of one
# training forward and backward over 2 blocks)
NEW_ENCODERS = {
    "multiconvformer": ({}, {"rel_attention_fwd": 2, "rel_attention_bwd": 2,
                             "dwconv1d_fwd": 10, "dwconv1d_bwd": 10}),
    "vgg_rnn": ({}, {"lstm_fwd": 4, "lstm_bwd": 4}),
    "rnn": ({}, {"lstm_fwd": 4, "lstm_bwd": 4}),
    "longformer": ({}, {}),
    "whisper_style": ({}, {}),
    # layer norms: behind a batch norm a bias's gradient cancels down to
    # its own float32 rounding, which no element-wise check at 1e-4 of its
    # largest value holds
    "s4": (dict(ss_layers=("s4", "s4d", "mha", "ff"), ss_d_state=16), {}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(NEW_ENCODERS))
def test_new_encoders_on_the_card_match_the_cpu(card, kind):
    """Each encoder of this slice, 2 blocks with mixed lengths, forward and
    backward: the card (kernels, cuFFT, cuDNN's convs) against the CPU
    (plain versions), and the kernel launches of the card's pass (the
    MultiConvformer: one rel-pos and five depthwise launches a block each
    way; the (VGG-)RNN encoder: one LSTM launch a direction a layer each
    way)."""
    over, launches = NEW_ENCODERS[kind]
    cfg = tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=256,
                                num_blocks=2, dropout_rate=0.0, positional_dropout_rate=0.0,
                                **over)
    rng = np.random.default_rng(0)
    feats, lengths = _rand(rng, 3, 157, 40, scale=1.0), torch.tensor([157, 120, 61])
    build = lambda dev: tconf.make_encoder(kind, cfg, 40, device=dev)  # noqa: E731
    t_out = build("cpu")(feats, lengths)[0].shape[1]
    counts = _card_vs_cpu(card, build, (feats, lengths), lengths, (3, t_out, 64))
    assert {k: v for k, v in counts.items() if v} == launches


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rnn", "s4", "lightconv", "dynamicconv"])
def test_new_decoders_on_the_card_match_the_cpu(card, kind):
    """Each decoder of this slice inside an ASRModel (2 blocks, the JAX
    config mapping), teacher-forced logits and every gradient, card
    against the CPU; the logits at the last position (``only_last``) in
    eval."""
    cfg = ASRModelConfig(
        vocab_size=50, frontend=FrontendConfig(n_mels=40), normalize="utterance_mvn",
        encoder_type="transformer",
        encoder=tconf.ConformerConfig(output_size=64, attention_heads=2, linear_units=128,
                                      num_blocks=1, pos_enc_layer_type="abs_pos",
                                      dropout_rate=0.0, positional_dropout_rate=0.0),
        decoder_type=kind,
        decoder=TransformerDecoderConfig(attention_heads=2, linear_units=96, num_blocks=2,
                                         dropout_rate=0.0, positional_dropout_rate=0.0))
    rng = np.random.default_rng(2)
    enc = _rand(rng, 3, 40, 64, scale=1.0)
    enc_lens = torch.tensor([40, 31, 12])
    ys = torch.from_numpy(rng.integers(0, 50, (3, 9)))
    ys_lens = torch.tensor([9, 5, 1])
    args = (enc, enc_lens, ys, ys_lens)
    build = lambda dev: ASRModel(cfg, device=dev).decoder  # noqa: E731
    counts = _card_vs_cpu(card, build, args, ys_lens, (3, 9, 50))
    assert not any(counts.values())
    _card_vs_cpu(card, lambda dev: _OnlyLast(build(dev)), args, ys_lens, (3, 50), train=False)


class _OnlyLast(torch.nn.Module):
    def __init__(self, decoder):
        super().__init__()
        self.decoder = decoder

    def forward(self, *args):
        return self.decoder(*args, only_last=True)


# the pretrained Hugging Face choices (chip_smoke.py phases 28-30) at tiny
# widths; the directories hold a config.json alone (weights from a seed)
TINY_W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=48, conv_dim=[16, 16], conv_kernel=[10, 3], conv_stride=[5, 2],
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
TINY_ENC = dict(output_size=64, attention_heads=2, linear_units=128, num_blocks=2,
                macaron_style=True, cnn_module_kernel=15, dropout_rate=0.0,
                positional_dropout_rate=0.0, attention_dropout_rate=0.0)


def _hf_config(kind, root):
    """(task config, Conformer encoder?) of one pretrained choice."""
    import json

    (root / "w2v").mkdir(exist_ok=True)
    (root / "w2v" / "config.json").write_text(json.dumps({**TINY_W2V, "model_type": "hubert"}))
    (root / "whisper").mkdir(exist_ok=True)
    (root / "whisper" / "config.json").write_text(json.dumps(dict(
        model_type="whisper", d_model=32, encoder_layers=2, encoder_attention_heads=2,
        encoder_ffn_dim=48, num_mel_bins=40, max_source_positions=200)))
    (root / "bert").mkdir(exist_ok=True)
    (root / "bert" / "config.json").write_text(json.dumps(dict(
        model_type="bert", hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=48, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)))
    base = {"token_list": [f"t{i}" for i in range(30)], "normalize": "utterance_mvn",
            "frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 40},
            "encoder_conf": dict(TINY_ENC), "model_conf": {"ctc_weight": 0.3},
            "decoder_conf": {"attention_heads": 2, "linear_units": 64, "num_blocks": 1,
                             "dropout_rate": 0.0, "positional_dropout_rate": 0.0},
            "_skip_pretrained_encoder": True, "_skip_llm_weights": True}
    raw = {"frontend": "none", "normalize": "none"}
    return {
        "ssl": ({**base, "frontend": "ssl", "frontend_conf": {
            "model_name_or_path": str(root / "w2v"), "kind": "hubert"}}, True),
        "hubert_hf": ({**base, **raw, "encoder": "hubert_hf", "encoder_conf": {
            "model_name_or_path": str(root / "w2v"), "output_size": 64}}, False),
        "whisper_hf": ({**base, "encoder": "whisper_hf", "encoder_conf": {
            "model_name_or_path": str(root / "whisper"), "output_size": 64}}, False),
        "sinc": ({**base, "normalize": "none", "preencoder": "sinc",
                  "frontend_conf": {"type": "sliding_window", "win_length": 400,
                                    "hop_length": 320},
                  "preencoder_conf": {"out_channels": 32, "sinc_channels": 16,
                                      "dropout_rate": 0.0},
                  "encoder_conf": {**TINY_ENC, "input_layer": "linear"},
                  "postencoder": "length_adaptor",
                  "postencoder_conf": {"n_layers": 1, "dropout_rate": 0.0}}, True),
        "bert": ({**base, "postencoder": "hugging_face_transformers",
                  "postencoder_conf": {"model_name_or_path": str(root / "bert"),
                                       "length_adaptor_n_layers": 1}}, True),
        "fused": ({**base, "frontend_conf": {"fused": [[256, 128, 40], [512, 160, 30]],
                                             "proj_dim": 20}}, True),
    }[kind]


# A gradient that misses the CPU's float32 one is checked in float64: the
# card's float64 gradient must equal the CPU's (to 1e-6 of the tolerance:
# the same function), and the card's float32 gradient may sit no further
# from it than the CPU's float32 one does, plus the tolerance.  The port's
# losses and softmaxes stay in float64 there, so the reference is float64
# throughout.  tools/grad_rounding.py, over six seeds of the six models
# below: only hubert_hf misses (its random trunk's CTC loss is large, and
# the float32 CTC gradient at the logits sits ~1e-3 off float64 on both
# devices alike); the float64 gradients agree to <= 4.6e-12, and the card
# is 0.85-1.01 times as far from them as the CPU.


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ssl", "hubert_hf", "whisper_hf", "sinc", "bert", "fused"])
def test_pretrained_choices_on_the_card_match_the_cpu(card, kind, tmp_path, monkeypatch):
    """Each choice built by ASRTask (weights from seed 0), card against
    CPU on a ragged batch: in eval mode the encoder rows (1e-4), the loss
    (rtol 1e-4) and its gradients (1e-4 of each tensor's largest CPU
    value, + 1e-6 of the model's largest; one that misses is checked in
    float64, as said above), one launch of each encoder forward per
    Conformer block and none over the SSL and Whisper encoders, and for
    ``frontend: ssl`` the features (1e-4); then in training mode one fused AdamW step (weight
    decay 0.01) on each device: the loss (rtol 1e-4) and every parameter
    and buffer after it, the batch norms' running statistics included
    (1e-5), with the sinc blocks' fixed 0.1 dropout drawing the same masks
    on both devices, and for ``frontend: ssl`` the frozen trunk decayed as
    optax's AdamW leaves it, w * (1 - lr wd)."""
    from llm_guided_asr_tpu_torch.models import preencoder
    from llm_guided_asr_tpu_torch.tasks import asr as tasr

    config, conformer = _hf_config(kind, tmp_path)
    config = {**tasr.ASRTask.get_default_config(), **config}
    cpu = tasr.init_model_variables(tasr.build_model(config, "cpu"), config, 0).eval()
    gpu = tasr.build_model(config, card).eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    batch = {"speech": _rand(rng, 3, 16000, scale=0.1),
             "speech_lengths": torch.tensor([16000, 12000, 7000]),
             "text": torch.from_numpy(rng.integers(1, 29, (3, 6))),
             "text_lengths": torch.tensor([6, 4, 5])}
    args = ("speech", "speech_lengths", "text", "text_lengths")
    before = _counts()
    with torch.no_grad():
        enc_gpu, lens_gpu = gpu.encode(batch["speech"].to(card), batch["speech_lengths"].to(card))
        torch.cuda.synchronize()
        blocks = 2 if conformer else 0
        assert _counts() == {k: n + (blocks if k in ("rel_attention_fwd", "dwconv1d_fwd") else 0)
                             for k, n in before.items()}
        enc_cpu, lens_cpu = cpu.encode(batch["speech"], batch["speech_lengths"])
        if kind == "ssl":
            feats = gpu.raw_features(batch["speech"].to(card), batch["speech_lengths"].to(card))
            want = cpu.raw_features(batch["speech"], batch["speech_lengths"])
            torch.testing.assert_close(feats[0].cpu(), want[0], rtol=0, atol=1e-4)
    assert torch.equal(lens_gpu.cpu(), lens_cpu)
    torch.testing.assert_close(enc_gpu.cpu(), enc_cpu, rtol=0, atol=1e-4)
    losses = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        loss = model(*(batch[k].to(dev) for k in args))[0]
        loss.backward()
        losses[name] = loss.item()
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    want = {n: p.grad for n, p in cpu.named_parameters() if p.grad is not None}
    floor = 1e-6 * max(g.abs().max().item() for g in want.values())
    exact = None
    for name, p in gpu.named_parameters():
        assert (p.grad is None) == (name not in want), name
        if p.grad is None:
            continue
        got, ref = p.grad.cpu(), want[name]
        tol = 1e-4 * ref.abs().max().item() + floor
        miss = (got - ref).abs().max().item()
        if miss > tol:
            exact = exact or (_float64_grads(cpu, batch, args), _float64_grads(gpu, batch, args))
            truth = exact[0][name]
            gap = (exact[1][name] - truth).abs().max().item()
            assert gap <= 1e-6 * tol, f"{name}: float64 on the card {gap:.3e} from the CPU's"
            miss = (got.double() - truth).abs().max().item()
            own = (ref.double() - truth).abs().max().item()
            assert miss <= own + tol, (f"{name}: {miss:.3e} from the float64 gradient > the "
                                       f"CPU's float32 {own:.3e} + {tol:.3e}")
            print(f"{name}: card {miss:.3e}, CPU float32 {own:.3e} from the float64 gradient")
    masks = torch.Generator()

    def same_masks(x, rate, rng):
        # the port's dropout with its keep mask drawn on the CPU
        if rate == 0.0:
            return x
        keep = (torch.rand(x.shape, generator=masks) >= rate).to(x.device)
        return torch.where(keep, x / (1.0 - rate), 0.0)

    monkeypatch.setattr(preencoder, "dropout", same_masks)
    w0 = {n: p.detach().clone() for n, p in gpu.named_parameters()}
    losses = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        state = init_train_state(model, build_optimizer("adamw", {"lr": 1e-3, "eps": 1e-3,
                                                                 "weight_decay": 0.01}))
        masks.manual_seed(0)
        stats, _ = make_fused_train_step(model.train(), state, torch.Generator().manual_seed(0))(
            {k: v.to(dev) for k, v in batch.items()})
        losses[name] = float(stats["loss"])
    np.testing.assert_allclose(losses["gpu"], losses["cpu"], rtol=1e-4)
    want = cpu.state_dict()
    for name, got in gpu.state_dict().items():
        torch.testing.assert_close(got.cpu(), want[name], rtol=0, atol=1e-5, msg=name)
    if kind == "ssl":
        assert not gpu.ssl_frontend.training
        for name, p in gpu.ssl_frontend.named_parameters():
            torch.testing.assert_close(p.detach(), w0["ssl_frontend." + name] * (1 - 1e-3 * 0.01),
                                       rtol=1e-6, atol=0, msg=name)


def _float64_grads(model, batch, args):
    """The model's gradients of ``batch`` in float64, on the CPU."""
    import copy

    m = copy.deepcopy(model).double()
    m.zero_grad(set_to_none=True)
    dev = next(m.parameters()).device
    m(*(batch[k].to(dev, torch.float64) if batch[k].is_floating_point() else batch[k].to(dev)
        for k in args))[0].backward()
    return {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}


@pytest.mark.gpu
def test_hf_decoder_on_the_card_matches_the_cpu(card, tmp_path):
    """decoder: hugging_face over a tiny Llama (weights from seed 0, an
    empty prompt): the teacher-forced logits (1e-4) and the 4-best from the
    card's encoder rows, card against the CPU (tokens equal, scores 1e-4)."""
    import json

    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.tasks import asr as tasr

    (tmp_path / "config.json").write_text(json.dumps(dict(
        model_type="llama", vocab_size=40, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5,
        max_position_embeddings=512)))
    config = {**tasr.ASRTask.get_default_config(), **_hf_config("bert", tmp_path)[0],
              "postencoder": None, "token_list": [f"t{i}" for i in range(40)],
              "decoder": "hugging_face", "_skip_llm_weights": True,
              "decoder_conf": {"model_name_or_path": str(tmp_path), "enc_frames_max": 64}}
    cpu = tasr.init_model_variables(tasr.build_model(config, "cpu"), config, 0).eval()
    gpu = tasr.build_model(config, card).eval()
    gpu.load_state_dict(cpu.state_dict())
    speech = _rand(np.random.default_rng(3), 1, 16000, scale=0.1)
    decode = dict(ctc_weight=0.3, beam_size=4, maxlenratio=-8.0, nbest=4)
    with torch.inference_mode():
        enc, lens = gpu.encode(speech.to(card), torch.tensor([16000], device=card))
        got = Speech2Text.from_model(gpu, **decode).beam(enc, lens, maxlenratio=-8.0, nbest=4)
        want = Speech2Text.from_model(cpu, **decode).beam(enc.cpu(), lens.cpu(),
                                                          maxlenratio=-8.0, nbest=4)
        ys = torch.tensor([[39, 3, 5, 7]])
        logits_gpu = gpu.decoder_logits(enc, lens, ys.to(card), torch.tensor([4], device=card))
        logits_cpu = cpu.decoder_logits(enc.cpu(), lens.cpu(), ys, torch.tensor([4]))
    torch.testing.assert_close(logits_gpu.cpu(), logits_cpu, rtol=0, atol=1e-4)
    assert [h.yseq for h in got] == [h.yseq for h in want]
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=0, atol=1e-4)


# the bfloat16 transducers and encoders, decoders and post-encoders beyond
# the Conformer with the transformer decoder, at tiny widths (features in):
# kind -> (the model's class and config keywords, the kernel launches of
# one training forward and backward by dtype)
_B16, _F32 = str(torch.bfloat16), str(torch.float32)
_CONF = {"rel_attention_fwd": {_B16: 2}, "rel_attention_bwd": {_B16: 2},
         "dwconv1d_fwd": {_B16: 2}, "dwconv1d_bwd": {_B16: 2}}
_CONF1 = {name: {_B16: 1} for name in _CONF}  # one Conformer block
BF16_MODELS = {
    "e_branchformer": ("asr", dict(encoder_type="e_branchformer"), _CONF),
    "branchformer": ("asr", dict(encoder_type="branchformer"), _CONF),
    "multiconvformer": ("asr", dict(encoder_type="multiconvformer"),
                        {**_CONF, "dwconv1d_fwd": {_B16: 10}, "dwconv1d_bwd": {_B16: 10}}),
    "vgg_rnn": ("asr", dict(encoder_type="vgg_rnn"), {"lstm_fwd": {_F32: 4},
                                                      "lstm_bwd": {_F32: 4}}),
    "rnn": ("asr", dict(encoder_type="rnn", input_layer="linear"),
            {"lstm_fwd": {_F32: 4}, "lstm_bwd": {_F32: 4}}),
    "transformer": ("asr", dict(encoder_type="transformer"), {}),
    "longformer": ("asr", dict(encoder_type="longformer"), {}),
    "whisper_style": ("asr", dict(encoder_type="whisper_style"), {}),
    "s4": ("asr", dict(encoder_type="s4", ss_layers=("s4", "s4d", "ff"), ss_d_state=16), {}),
    "rnn-decoder": ("asr", dict(decoder_type="rnn"), _CONF1),
    "s4-decoder": ("asr", dict(decoder_type="s4"), _CONF1),
    "lightconv": ("asr", dict(decoder_type="lightconv"), _CONF1),
    "dynamicconv": ("asr", dict(decoder_type="dynamicconv"), _CONF1),
    "hugging_face": ("asr", dict(decoder_type="hugging_face"), _CONF1),
    "length_adaptor": ("asr", dict(postencoder="length_adaptor"), _CONF1),
    "bert": ("asr", dict(postencoder="bert"), _CONF1),
    "transducer-stateless": ("transducer", dict(decoder_type="stateless"), _CONF),
    "transducer-rnn": ("transducer", dict(decoder_type="rnn"),
                       {**_CONF, "lstm_fwd": {_F32: 1}, "lstm_bwd": {_F32: 1}}),
    "transducer-rwkv": ("transducer", dict(decoder_type="rwkv"),
                        {**_CONF, "wkv_fwd": {_F32: 2}, "wkv_bwd": {_F32: 2}}),
    "transducer-mega": ("transducer", dict(decoder_type="mega"), _CONF),
    "transducer-multi_blank": ("transducer", dict(decoder_type="rnn", multi_blank=True),
                               {**_CONF, "lstm_fwd": {_F32: 1}, "lstm_bwd": {_F32: 1}}),
    # the contextual-block Conformer: one block of 40 a layer at 20 sub-frames
    "contextual_block": ("asr", dict(encoder_type="contextual_block_conformer"),
                         {"dwconv1d_fwd": {_B16: 2}, "dwconv1d_bwd": {_B16: 2}}),
    "avhubert": ("asr", dict(encoder_type="avhubert"), {}),
}


def _bf16_model(kind, dev, dtype):
    """The model of BF16_MODELS[kind] on ``dev`` computing in ``dtype``:
    vocab 50, 2 blocks of 64 (1 for the Conformer under a new decoder or
    post-encoder), features of 40 in, no dropout; weights from seed 0."""
    from llm_guided_asr_tpu_torch.models import transducer as ttd
    from llm_guided_asr_tpu_torch.models.hf_encoder import BertBodyConfig, HFPostEncoderConfig
    from llm_guided_asr_tpu_torch.models.preencoder import LengthAdaptorConfig

    family, over, _ = BF16_MODELS[kind]
    over = dict(over)
    enc = dict(output_size=64, attention_heads=2, linear_units=128, num_blocks=2,
               cnn_module_kernel=15, dropout_rate=0.0, positional_dropout_rate=0.0,
               attention_dropout_rate=0.0)
    for k in ("input_layer", "ss_layers", "ss_d_state"):
        if k in over:
            enc[k] = over.pop(k)
    if family == "transducer":
        multi = over.pop("multi_blank", False)
        dec = ttd.TransducerDecoderConfig(embed_size=32, hidden_size=48, num_layers=2,
                                          mega_qk_size=16, mega_num_heads=2, **over)
        if over["decoder_type"] in ("rnn", "stateless"):
            dec = ttd.TransducerDecoderConfig(embed_size=32, hidden_size=48, num_layers=1,
                                              **over)
        cfg = ttd.TransducerModelConfig(
            vocab_size=50, frontend=None, normalize="none", input_size=40,
            encoder=tconf.ConformerConfig(**enc), decoder=dec, joint_size=32,
            aux_ctc_weight=0.3, multi_blank_durations=(2, 3) if multi else ())
        return init_weights(ttd.TransducerModel(cfg, device=dev, dtype=dtype), seed=0)
    post = over.pop("postencoder", None)
    if post == "length_adaptor":
        post = ("length_adaptor", LengthAdaptorConfig(n_layers=1))
    elif post == "bert":
        post = ("hugging_face_transformers", HFPostEncoderConfig(body=BertBodyConfig(
            hidden_size=64, num_hidden_layers=1, num_attention_heads=2, intermediate_size=96,
            hidden_dropout=0.0, attention_dropout=0.0)))
    if "decoder_type" in over or post is not None:
        enc["num_blocks"] = 1
    if over.get("decoder_type") == "hugging_face":
        from llm_guided_asr_tpu_torch.models.hf_decoder import HFCausalDecoderConfig
        from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig

        over["hf_decoder"] = HFCausalDecoderConfig(
            llm=LlamaConfig(vocab_size=50, hidden_size=32, intermediate_size=48,
                            num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1),
            prefix_ids=(1,), postfix_ids=(2,), enc_frames_max=32)
    cfg = ASRModelConfig(
        vocab_size=50, frontend=None, normalize="none", input_size=40, ctc_weight=0.3,
        encoder=tconf.ConformerConfig(**enc), postencoder=post,
        decoder=TransformerDecoderConfig(attention_heads=2, linear_units=96, num_blocks=1,
                                         dropout_rate=0.0, positional_dropout_rate=0.0),
        **over)
    return init_weights(ASRModel(cfg, device=dev, dtype=dtype), seed=0)


def _dtype_launches():
    from llm_guided_asr_tpu_torch.ops import lstm as tl

    return {name: dict(by) for k in (tra.KERNEL, tdw.KERNEL, twkv.KERNEL, tfa.KERNEL, tl.KERNEL)
            for name, by in k.dtype_launches.items()}


def _loss_and_grad(model, batch):
    loss, _, _ = model(*batch)
    loss.backward()
    grad = torch.cat([p.grad.reshape(-1).float().cpu() for p in model.parameters()
                      if p.grad is not None])
    return float(loss.detach()), grad


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(BF16_MODELS))
def test_bf16_models_on_the_card_match_the_cpu(card, kind):
    """Each bfloat16 model of BF16_MODELS (float32 weights from seed 0), one
    training-mode forward and backward of a ragged batch: the card's
    bfloat16 run sits as close to the CPU's float32 plain path as the
    CPU's own bfloat16 run does (loss and the whole gradient: within twice
    the CPU's bfloat16 error plus 1e-3 of the reference); the card's kernel
    launches by operand dtype: the encoder kernels in bfloat16, the WKV and
    LSTM kernels in float32, as JAX computes them in a bfloat16 model."""
    rng = np.random.default_rng(3)
    feats, lengths = _rand(rng, 3, 83, 40, scale=1.0), torch.tensor([83, 70, 41])
    text = torch.from_numpy(rng.integers(1, 45, (3, 5)))
    text_lens = torch.tensor([5, 3, 4])
    text = torch.where(torch.arange(5)[None] < text_lens[:, None], text, -1)
    batch = (feats, lengths, text, text_lens)
    runs, weights = {}, None
    for name, dev, dtype in (("ref", "cpu", torch.float32), ("cpu", "cpu", torch.bfloat16),
                             ("card", card, torch.bfloat16)):
        model = _bf16_model(kind, dev, dtype).train()
        if weights is None:  # the CPU's draw (a card draws other numbers from the seed)
            weights = model.state_dict()
        model.load_state_dict(weights)
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        before = _dtype_launches()
        runs[name] = _loss_and_grad(model, tuple(x.to(dev) for x in batch))
        torch.cuda.synchronize()
        after = _dtype_launches()
    got = {n: {dt: c - before[n].get(dt, 0) for dt, c in by.items() if c - before[n].get(dt, 0)}
           for n, by in after.items()}
    assert {n: by for n, by in got.items() if by} == BF16_MODELS[kind][2]
    (ref_l, ref_g), (cpu_l, cpu_g), (card_l, card_g) = runs["ref"], runs["cpu"], runs["card"]
    assert abs(card_l - ref_l) <= 2 * abs(cpu_l - ref_l) + 1e-3 * abs(ref_l), (card_l, cpu_l,
                                                                               ref_l)
    e_cpu, e_card = (cpu_g - ref_g).norm().item(), (card_g - ref_g).norm().item()
    assert e_card <= 2 * e_cpu + 1e-3 * ref_g.norm().item(), (e_card, e_cpu)
