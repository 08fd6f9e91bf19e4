"""Port vs JAX, the flash-attention Conformer's attention: the plain flash op
and its gradients against the library's TPU flash attention in interpret
mode (padded and segmented exactly as the JAX FlashSelfAttention does), the
port's FlashSelfAttention against both branches of the JAX module, and a
2-block Conformer encoder with flash, dense or rel-pos attention.  The JAX
module's TPU branch runs here through a stand-in for its ``jax`` name that
reports a TPU, with ``pallas_call`` in interpret mode; the JAX package is not
changed.  The CUDA kernels themselves are held against the plain version on
the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import contextlib
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import transformer as jtr
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.conformer import ConformerEncoder as JConformerEncoder
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder
from llm_guided_asr_tpu_torch.models.transformer import FlashSelfAttention
from llm_guided_asr_tpu_torch.ops import flash_attention as tfa
from test_torch_train import NO_DROP_ENC, _np
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)


class _TPUJax:
    """``jax`` for llm_guided_asr_tpu.models.transformer, except that
    ``devices()`` reports a TPU, so that FlashSelfAttention takes its TPU
    branch (the library flash attention) on the CPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def devices(*args, **kwargs):
        return [types.SimpleNamespace(platform="tpu")]


@contextlib.contextmanager
def tpu_branch():
    """The library's Pallas kernels in interpret mode and the module's TPU
    branch, for the duration of a trace."""
    from jax.experimental import pallas as pl

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(jtr, "jax", _TPUJax())
        yield


def library_flash(q, k, v, valid, sm_scale):
    """The library call as FlashSelfAttention makes it on a TPU (:473-496):
    T padded to a multiple of 128, frames in segment 1 and pads in segment
    0, blocks of min(512, Tpad); then the pad query rows zeroed."""
    from jax.experimental.pallas.ops.tpu import flash_attention as fa

    t = q.shape[2]
    pad = (-t) % 128
    pad_t = lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))  # noqa: E731
    seg = jnp.pad(valid.astype(jnp.int32), ((0, 0), (0, pad)))
    blk = min(512, t + pad)
    sizes = fa.BlockSizes(block_q=blk, block_k_major=blk, block_k=blk, block_b=1,
                          block_q_major_dkv=blk, block_k_major_dkv=blk, block_k_dkv=blk,
                          block_q_dkv=blk, block_k_major_dq=blk, block_k_dq=blk, block_q_dq=blk)
    out = fa.flash_attention(pad_t(q), pad_t(k), pad_t(v), segment_ids=fa.SegmentIds(seg, seg),
                             sm_scale=sm_scale, block_sizes=sizes)
    return jnp.where(valid[:, None, :, None], out[:, :, :t], 0.0)


def _lengths_mask(t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("t,dk,lengths", [(150, 64, [150, 101]), (256, 128, [256, 200]),
                                          (150, 128, [150, 0])])
def test_plain_flash_attention_matches_the_library_kernel(t, dk, lengths):
    """Forward at 1e-5; dq, dk, dv at 1e-4 of the largest reference value.
    The lengths give one batch row with pads (and one of pads only)."""
    rng = np.random.default_rng(t + dk)
    q, k, v, g = (rng.standard_normal((2, 2, t, dk)).astype(np.float32) for _ in range(4))
    valid = _lengths_mask(t, lengths)
    sm = 1.0 / math.sqrt(dk)

    def vjp(q, k, v, g):
        out, pull = jax.vjp(lambda *a: library_flash(*a, jnp.asarray(valid), sm), q, k, v)
        return out, pull(g)

    with tpu_branch():
        j_out, j_grads = jax.jit(vjp)(*map(jnp.asarray, (q, k, v, g)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = dict(tfa.KERNEL.launches)
    out = tfa.flash_attention(*leaves, torch.from_numpy(valid.astype(np.int32)), sm)
    out.backward(torch.from_numpy(g))
    assert tfa.KERNEL.launches == before  # the CPU runs the plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=1e-5)
    assert np.all(out.detach().numpy().transpose(0, 2, 1, 3)[~valid] == 0)  # pad query rows
    for name, leaf, jg in zip(("dq", "dk", "dv"), leaves, j_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0,
                                   atol=1e-4 * np.abs(jg).max(), err_msg=name)


def test_flash_lse_and_backward_entry_points():
    """flash_attention_fwd's log-sum-exp over the valid keys (0 at pad rows)
    and flash_attention_bwd agree with the autograd function's gradients."""
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 3, 19, 64)).astype(np.float32))
                  for _ in range(4))
    valid = torch.from_numpy(_lengths_mask(19, [19, 7]).astype(np.int32))
    out, lse = tfa.flash_attention_fwd(q, k, v, valid, 0.125)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.125
    want = torch.logsumexp(scores.masked_fill(~valid.bool()[:, None, None, :], -torch.inf), -1)
    want = want.masked_fill(~valid.bool()[:, None, :], 0.0)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tfa.flash_attention(*leaves, valid, 0.125).backward(g)
    for leaf, grad in zip(leaves, tfa.flash_attention_bwd(q, k, v, valid, out, lse, g, 0.125)):
        torch.testing.assert_close(leaf.grad, grad)
    with pytest.raises(TypeError, match="int32"):
        tfa.flash_attention(q, k, v, valid.bool(), 0.125)
    with pytest.raises(ValueError, match="valid"):
        tfa.flash_attention(q, k, v, valid[:, :5], 0.125)


@pytest.mark.parametrize("d_model,heads", [(128, 2), (32, 2)])
def test_flash_self_attention_matches_both_jax_branches(d_model, heads):
    """Head dim 64: the port's flash path equals the JAX module's TPU branch
    on every row, pad rows included (their attention output is zeroed
    before linear_out, so they hold its bias), and its CPU dense branch on
    the valid rows only.  Head dim 16: both packages take the dense branch
    and agree on every row."""
    t, lengths = 150, [150, 101]
    rng = np.random.default_rng(d_model)
    x = rng.standard_normal((2, t, d_model)).astype(np.float32)
    valid = _lengths_mask(t, lengths)
    jmod = jtr.FlashSelfAttention(num_heads=heads)
    variables = seeded_variables(jmod, jnp.asarray(x), jnp.asarray(valid), seed=1)
    port = FlashSelfAttention(d_model, heads)
    port.load_state_dict(params_from_jax(_np(variables)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    dense = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x), jnp.asarray(valid)))
    with tpu_branch():
        tpu = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x), jnp.asarray(valid)))
    np.testing.assert_allclose(got[valid], dense[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, tpu, rtol=1e-5, atol=1e-5)
    if d_model // heads in tfa.HEAD_DIMS:  # pad rows: linear_out of a zero attention output
        bias = variables["params"]["linear_out"]["bias"]
        np.testing.assert_allclose(got[~valid], np.broadcast_to(bias, got[~valid].shape),
                                   rtol=0, atol=1e-6)
        assert not np.allclose(dense[~valid], tpu[~valid], atol=1e-2)  # two branches ran
    else:
        np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


ENC = dict(output_size=128, attention_heads=2, linear_units=64, num_blocks=2, macaron_style=True,
           cnn_module_kernel=7, **NO_DROP_ENC)
FEATS, FEAT_LENGTHS = 603, [603, 410]  # T' = 150 and 102 after the x4 subsampling


@pytest.mark.parametrize("attn,pos,pad_safe,branch", [
    ("flash", "abs_pos", True, "cpu"),
    ("flash", "abs_pos", True, "tpu"),
    ("flash", "abs_pos", False, "tpu"),  # pads convolved: only the TPU branch's pad rows match
    ("selfattn", "abs_pos", True, "cpu"),
    ("flash", "rel_pos", True, "cpu"),   # the relative table is computed and unused
    ("rel_selfattn", "rel_pos", False, "cpu"),
])
def test_conformer_encoder_attention_types_match_jax(attn, pos, pad_safe, branch):
    """A 2-block encoder (head dim 64) at 1e-4, from the same weights."""
    cfg = dict(ENC, pos_enc_layer_type=pos, selfattention_layer_type=attn,
               pad_safe_conv=pad_safe)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, FEATS, 20)).astype(np.float32)
    lengths = np.array(FEAT_LENGTHS, np.int32)
    jenc = JConformerEncoder(JConformerConfig(**cfg))
    variables = seeded_variables(jenc, jnp.asarray(feats), jnp.asarray(lengths), seed=2)
    with tpu_branch() if branch == "tpu" else contextlib.nullcontext():
        want, want_lens = jax.jit(jenc.apply)(variables, jnp.asarray(feats), jnp.asarray(lengths))
    tenc = ConformerEncoder(ConformerConfig(**cfg), 20, device="cpu").eval()
    tenc.load_state_dict(params_from_jax(_np(variables)), strict=True)
    with torch.no_grad():
        got, got_lens = tenc(torch.from_numpy(feats), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if not pad_safe:  # the pads reach the valid frames, so JAX's two branches disagree
        dense, _ = jax.jit(jenc.apply)(variables, jnp.asarray(feats), jnp.asarray(lengths))
        assert (branch == "cpu") == np.allclose(np.asarray(dense), want, rtol=1e-4, atol=1e-4)


def test_encoder_rejects_what_it_does_not_port():
    with pytest.raises(ValueError, match="rel_pos"):
        ConformerEncoder(ConformerConfig(**dict(ENC, pos_enc_layer_type="abs_pos")), 20,
                         device="cpu")
    with pytest.raises(ValueError, match="selfattention_layer_type"):
        ConformerEncoder(ConformerConfig(**dict(ENC, selfattention_layer_type="lf_selfattn")),
                         20, device="cpu")
    with pytest.raises(ValueError, match="input_layer"):  # JAX's Conformer raises too
        ConformerEncoder(ConformerConfig(**dict(ENC, input_layer="conv1d")), 20, device="cpu")
