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

from llm_guided_asr_tpu_torch.models import conformer as tconf
from llm_guided_asr_tpu_torch.ops import depthwise_conv as tdw
from llm_guided_asr_tpu_torch.ops import rel_attention as tra

# bf16 outputs are rounded to 8 mantissa bits; float32 differs only by the
# order of the sums
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel_attention_tol(ref):
    """float32: the order of the sums; bfloat16: at most one unit in the last
    place of the output, 2**-7 of the largest one."""
    if ref.dtype == torch.float32:
        return 1e-5
    return 2.0 ** -7 * ref.float().abs().max().item() + 1e-5


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
    before = tra.KERNEL.launches
    out = tra.rel_attention(qu, qv, k, v, p, kv_valid, 1.0 / math.sqrt(dk))
    torch.cuda.synchronize()
    assert tra.KERNEL.launches == before + 1
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
    before = tdw.KERNEL.launches
    out = tdw.depthwise_conv1d(x, w)
    torch.cuda.synchronize()
    assert tdw.KERNEL.launches == before + 1
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
    before = (tra.KERNEL.launches, tdw.KERNEL.launches)
    with torch.no_grad():
        out_gpu, lens_gpu = gpu(feats.to(card), lengths.to(card))
        out_cpu, lens_cpu = cpu(feats, lengths)
    torch.cuda.synchronize()
    assert (tra.KERNEL.launches, tdw.KERNEL.launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(lens_gpu.cpu(), lens_cpu)
    torch.testing.assert_close(out_gpu.cpu(), out_cpu, rtol=1e-4, atol=1e-4)
