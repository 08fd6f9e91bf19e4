"""The port's CUDA kernels on the card, held against their plain versions.

Needs a CUDA card and nvcc; every test skips without a card.  This file
imports neither JAX nor the JAX package, so that it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py
"""

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
from llm_guided_asr_tpu_torch.ops import rel_attention as tra
from llm_guided_asr_tpu_torch.ops import wkv as twkv

# bf16 outputs are rounded to 8 mantissa bits; float32 differs only by the
# order of the sums
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel_attention_tol(ref):
    """float32: the order of the sums; bfloat16: at most one unit in the last
    place of the output, 2**-7 of the largest one."""
    if ref.dtype == torch.float32:
        return 1e-5
    return 2.0 ** -7 * ref.float().abs().max().item() + 1e-5


def _counts():
    return {**tra.KERNEL.launches, **tdw.KERNEL.launches, **twkv.KERNEL.launches}


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k_size", [(1, 312, 256, 31), (2, 100, 256, 8), (3, 17, 70, 5)])
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
])
def test_rel_attention_backward_matches_plain(card, dtype, rate, b, h, t, dk, lengths):
    """The kernels under autograd (forward with dropout, then the backward)
    against autograd through the plain version with the same hash mask."""
    rng = np.random.default_rng(t + dk)
    qu, qv, k, v = (_rand(rng, b, h, t, dk, scale=1.0).to(card, dtype) for _ in range(4))
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,c,k_size", [(4, 312, 256, 31), (2, 100, 256, 8), (3, 17, 70, 5)])
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
            assert _counts() == {k: n + (0 if k.startswith("wkv") else 2)
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
])
def test_wkv_kernel_matches_plain(card, b, t, c, k_scale, given_state):
    """float32, 1e-5: the same formula with expf and IEEE division; only
    the kernel's fused multiply-adds round differently."""
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
@pytest.mark.parametrize("b,t,c,k_scale", [
    (16, 25, 512, 1.0),  # training: the prediction network over U + 1 = 25 labels
    (2, 17, 70, 1.0),
    (1, 1, 33, 1.0),
    (3, 30, 40, 30.0),
])
def test_wkv_backward_matches_autograd(card, b, t, c, k_scale):
    """The backward kernel against autograd through the plain loop: every
    gradient at 1e-4 of its largest reference value; gw and gu are float32
    atomic sums over the batch, so their order changes between runs."""
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
            assert _counts() == {k: n + 2 for k, n in before.items()}
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
