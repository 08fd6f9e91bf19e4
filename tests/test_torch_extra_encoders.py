"""Port vs JAX, the MultiConvformer, (VGG-)RNN, Longformer, Whisper-style
and S4 encoders and the compositional state-space stack, from the same
weights carried across by params_from_jax (``strict=True``).

Tiny shapes (D = 16, 2 heads, linear_units 24; features [3, T, 20] with
ragged lengths, so that the reverse LSTM runs over pads and Whisper's
stride-2 SAME padding sees both parities), every dropout at 0, float32:

- each encoder in training mode: the output (pads zeroed where JAX zeroes
  them), the lengths, and the gradient of sum(out * r) for every
  parameter, rtol/atol 1e-4 (the Longformer over 150 frames, so that its
  64-frame band masks keys); ``vgg_rnn`` inside the transducer below;
- ``SequenceModel`` for each norm / residual / pool choice of
  tests/test_state_spaces.py, in training mode (batch statistics);
- the transducer over ``vgg_rnn`` (``make_encoder`` is shared): loss and
  every gradient;
- the new encoders take the card by default and raise without one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import conformer as jconf
from llm_guided_asr_tpu.models import state_spaces as jss
from llm_guided_asr_tpu.models import transducer as jtd
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu_torch.models import state_spaces as tss
from llm_guided_asr_tpu_torch.models import transducer as ttd
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from test_torch_branchformer import _load
from test_torch_decoders import _assert_grads
from test_torch_train import NO_DROP_ENC, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

N_FEATS = 20
ENC = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=2, **NO_DROP_ENC)
CASES = {  # encoder type -> (encoder_conf, frames, lengths)
    "multiconvformer": (dict(multicgmlp_kernel_sizes=(3, 7), num_blocks=1), 41, [41, 30, 17]),
    "rnn": (dict(input_layer="linear"), 11, [11, 7, 4]),
    "longformer": (dict(input_layer="linear", num_blocks=1), 150, [150, 101, 33]),
    # an even frame count: conv2 pads (0, 1); the ASRModel test of
    # tests/test_torch_decoders.py gives it an odd one, (1, 1)
    "whisper_style": (dict(num_blocks=1), 20, [20, 13, 8]),
    # the affine residual, post-norm
    "s4": (dict(ss_layers=("s4", "s4d", "ff"), ss_d_state=8, num_blocks=1,
                ss_residual="affine", ss_prenorm=False), 41, [41, 30, 17]),
}


def _jax_encoder(kind, cfg):
    if kind == "s4":
        return jss.S4Encoder(cfg)
    return jconf.make_encoder(kind, cfg)


def _run_pair(jmod, tmod, x, lengths):
    """Training-mode outputs of both, and the gradients of sum(out * r)."""
    jargs = (jnp.asarray(x), jnp.asarray(lengths))
    variables = seeded_variables(jmod, *jargs, seed=2)
    out_shape = jax.eval_shape(jmod.apply, variables, *jargs)[0].shape
    r = np.random.default_rng(3).standard_normal(out_shape).astype(np.float32)

    def j_loss(params):
        (out, out_lens), _ = jmod.apply({**variables, "params": params}, *jargs, False,
                                        mutable=["batch_stats"])
        return jnp.sum(out * r), (out, out_lens)

    (_, (j_out, j_lens)), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    _load(tmod, variables).train()
    out, out_lens = tmod(torch.from_numpy(x), torch.from_numpy(lengths).long())
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-4)
    (out * torch.from_numpy(r)).sum().backward()
    _assert_grads(tmod, j_grads)


@pytest.mark.parametrize("kind", list(CASES))
def test_encoder_matches_jax(kind):
    over, frames, lengths = CASES[kind]
    cfg = dict(ENC, **over)
    x = np.random.default_rng(0).standard_normal((3, frames, N_FEATS)).astype(np.float32)
    tmod = make_encoder(kind, ConformerConfig(**cfg), N_FEATS, device="cpu")
    assert tmod.output_size == ENC["output_size"]
    _run_pair(_jax_encoder(kind, jconf.ConformerConfig(**cfg)), tmod, x,
              np.array(lengths, np.int32))


@pytest.mark.parametrize("norm,residual,pool", [
    ("layer", "residual", "avg"), ("batch", "decay", "sample"), ("none", "highway", "linear")])
def test_sequence_model_matches_jax(norm, residual, pool):
    """The trunk of tests/test_state_spaces.py (s4d, mha, ff; 2 groups
    pooled by 2; causal: not bidirectional) with each norm, residual and
    pool of its tests (the affine residual and post-norm in the S4
    encoder's case above)."""
    cfg = dict(output_size=8, num_blocks=2, attention_heads=2, dropout_rate=0.0,
               ss_layers=("s4d", "mha", "ff"), ss_d_state=8, ss_norm=norm,
               ss_residual=residual, ss_pool=pool, ss_pool_stride=2, ss_bidirectional=False)
    x = np.random.default_rng(4).standard_normal((2, 12, 8)).astype(np.float32)
    tmod = tss.SequenceModel(ConformerConfig(**cfg))
    _run_pair(jss.SequenceModel(jconf.ConformerConfig(**cfg)), tmod, x,
              np.array([12, 9], np.int32))


def test_vgg_rnn_transducer_matches_jax():
    """The transducer picks the new encoders up through ``make_encoder``:
    ``vgg_rnn`` (VGG2L over the log-mel features, the bidirectional LSTM
    over the ragged batch's pads) with the LSTM prediction network, loss
    and every gradient."""
    enc = dict(ENC, num_blocks=1)
    dec = dict(decoder_type="rnn", embed_size=8, hidden_size=16, num_layers=1)
    fe = dict(n_fft=128, hop_length=64, n_mels=N_FEATS)
    common = dict(vocab_size=8, normalize="utterance_mvn", joint_size=16, aux_ctc_weight=0.1,
                  encoder_type="vgg_rnn")
    jmodel = jtd.TransducerModel(jtd.TransducerModelConfig(
        frontend=JFrontendConfig(**fe), encoder=jconf.ConformerConfig(**enc),
        decoder=jtd.TransducerDecoderConfig(**dec), **common))
    rng = np.random.default_rng(7)
    batch = (rng.standard_normal((2, 1600)).astype(np.float32), np.array([1600, 1100], np.int32),
             np.array([[1, 2, 3], [4, 5, -1]], np.int32), np.array([3, 2], np.int32))
    jargs = [jnp.asarray(x) for x in batch]
    variables = seeded_variables(jmodel, *jargs, seed=5)

    def j_loss(params):
        loss, stats, _ = jmodel.apply({**variables, "params": params}, *jargs,
                                      deterministic=False)
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    tmodel = _load(ttd.TransducerModel(ttd.TransducerModelConfig(
        frontend=FrontendConfig(**fe), encoder=ConformerConfig(**enc),
        decoder=ttd.TransducerDecoderConfig(**dec), **common), device="cpu"), variables).train()
    speech, lengths, text, tlens = (torch.from_numpy(x) for x in batch)
    loss, stats, _ = tmodel(speech, lengths, text.long(), tlens)
    loss.backward()
    assert stats.keys() == j_stats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    _assert_grads(tmodel, j_grads)


def test_new_encoders_require_a_card_by_default(monkeypatch):
    """No silent CPU fallback: without ``device`` the encoders take the card
    and raise on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in (*CASES, "vgg_rnn"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_encoder(kind, ConformerConfig(**ENC), N_FEATS)


def test_unknown_input_layer_raises():
    """JAX takes any input layer but ``conv2d`` as a Dense; the port takes
    ``linear`` and refuses the rest, ``none`` included."""
    for layer in ("conv2d6", "none"):
        cfg = dataclasses.replace(ConformerConfig(**ENC), input_layer=layer)
        for kind in ("multiconvformer", "longformer", "s4"):
            with pytest.raises(ValueError, match="input_layer"):
                make_encoder(kind, cfg, N_FEATS, device="cpu")
