"""Port vs JAX, the transducer model: the RWKV prediction network, the
RNN-T loss and its gradient (an empty label included), the model's loss
and every parameter's gradient (stateless and RWKV prediction networks),
and Speech2Text's dispatch, from the same weights (tests/test_transducer.py's
tiny config with every dropout at 0) carried across by params_from_jax.
The searches are in tests/test_torch_transducer_search.py, one fused
train step in tests/test_torch_transducer_train.py."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import transducer as jtd
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.rwkv import RWKVDecoder as JRWKVDecoder
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.ops.rnnt import rnnt_loss as j_rnnt_loss
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import transducer as ttd
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.rwkv import RWKVDecoder
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.rnnt import rnnt_loss
from llm_guided_asr_tpu_torch.ops.wkv import KERNEL as WKV_KERNEL
from llm_guided_asr_tpu_torch.search.transducer_beam import transducer_beam_decode
from test_torch_train import NO_DROP_ENC, _np, jit

torch.set_num_threads(1)

VOCAB = 8
# tests/test_transducer.py tiny_transducer_cfg, dropout off
TINY = dict(
    frontend=dict(n_fft=128, hop_length=64, n_mels=20),
    encoder=dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1,
                 use_cnn_module=False, **NO_DROP_ENC),
    decoder=dict(embed_size=16, hidden_size=16, num_layers=1),
)


def _configs(decoder_type):
    common = dict(vocab_size=VOCAB, normalize="utterance_mvn", joint_size=16, aux_ctc_weight=0.1)
    jcfg = jtd.TransducerModelConfig(
        frontend=JFrontendConfig(**TINY["frontend"]), encoder=JConformerConfig(**TINY["encoder"]),
        decoder=jtd.TransducerDecoderConfig(decoder_type=decoder_type, **TINY["decoder"]),
        **common)
    tcfg = ttd.TransducerModelConfig(
        frontend=FrontendConfig(**TINY["frontend"]), encoder=ConformerConfig(**TINY["encoder"]),
        decoder=ttd.TransducerDecoderConfig(decoder_type=decoder_type, **TINY["decoder"]),
        **common)
    return jcfg, tcfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"speech": rng.standard_normal((2, 1600)).astype(np.float32),
            "speech_lengths": np.array([1600, 900], np.int32),
            "text": np.array([[1, 2, 3], [4, 5, -1]], np.int32),
            "text_lengths": np.array([3, 2], np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


def seeded_variables(module, *args, seed=0):
    """The module's variables drawn from a numpy seed with init-like scales
    (dense and conv kernels 1/sqrt(fan-in), the RWKV mixes uniform in
    [0, 1), norm scales near 1, biases small), without compiling its init:
    jax.eval_shape traces it for the shapes only."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.startswith("mu_"):
            x = rng.uniform(0.0, 1.0, leaf.shape)
        elif name in ("scale", "inv_std", "var"):
            x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "kernel":
            x = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name in ("embedding", "time_decay", "time_first"):
            x = rng.standard_normal(leaf.shape) * (1.0 if name == "embedding" else 0.2)
        else:  # biases, the rel-pos biases, running means
            x = 0.1 * rng.standard_normal(leaf.shape)
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


_MODELS = {}


def _models(decoder_type):
    """(JAX model, its variables, the port's model with the same weights),
    built once per decoder type."""
    if decoder_type not in _MODELS:
        jcfg, tcfg = _configs(decoder_type)
        jmodel = jtd.TransducerModel(jcfg)
        batch = _batch(0)
        variables = seeded_variables(
            jmodel, *(jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS))
        tmodel = ttd.TransducerModel(tcfg, device="cpu")
        tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
        _MODELS[decoder_type] = jmodel, variables, tmodel
    return _MODELS[decoder_type]


def _encode(decoder_type, speech, lengths):
    """Both encoders on the same waveforms, held together at 1e-4."""
    jmodel, variables, tmodel = _models(decoder_type)
    enc, enc_lens = jit(functools.partial(jmodel.apply, method=jmodel.encode))(
        variables, jnp.asarray(speech), jnp.asarray(lengths))
    with torch.no_grad():
        tenc, tlens = tmodel.eval().encode(torch.from_numpy(speech), torch.from_numpy(lengths))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), rtol=1e-4, atol=1e-5)
    return (enc, enc_lens), (tenc, tlens)


def test_rwkv_decoder_matches_jax():
    """Two blocks, embed 12 projected to hidden 20 (C not a multiple of 8);
    labels past the vocabulary are clipped."""
    cfg = jtd.TransducerDecoderConfig(decoder_type="rwkv", embed_size=12, hidden_size=20,
                                      num_layers=2)
    labels = np.array([[1, 7, 3, 0, 9], [4, 4, 2, 6, 5]], np.int32)
    jdec = JRWKVDecoder(VOCAB, cfg)
    variables = seeded_variables(jdec, jnp.asarray(labels), seed=3)
    tdec = RWKVDecoder(VOCAB, ttd.TransducerDecoderConfig(
        decoder_type="rwkv", embed_size=12, hidden_size=20, num_layers=2))
    tdec.load_state_dict(params_from_jax(_np(variables)), strict=True)
    assert tdec.ln_in.eps == tdec.block_1.ln2.eps == 1e-6  # bare flax LayerNorms
    with torch.no_grad():
        got = tdec.eval()(torch.from_numpy(labels).long())
    want = np.asarray(jit(jdec.apply)(variables, jnp.asarray(labels)))
    assert got.shape == (2, 6, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


_j_rnnt_value_and_grad = jit(jax.value_and_grad(j_rnnt_loss))


@pytest.mark.parametrize("u_lens", [[3, 2], [0, 1]], ids=["labels", "empty_label"])
def test_rnnt_loss_and_gradient_match_jax(u_lens):
    rng = np.random.default_rng(sum(u_lens))
    logits = rng.standard_normal((2, 5, 4, 6)).astype(np.float32)
    labels = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    t_lens, u_lens = np.array([5, 4], np.int32), np.array(u_lens, np.int32)
    jloss, jgrad = _j_rnnt_value_and_grad(jnp.asarray(logits), jnp.asarray(labels),
                                          jnp.asarray(t_lens), jnp.asarray(u_lens))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = rnnt_loss(x, torch.from_numpy(labels).long(), torch.from_numpy(t_lens),
                     torch.from_numpy(u_lens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-6)
    assert np.allclose(x.grad.numpy()[1, 4], 0.0)  # the padded frame of example 1


@pytest.mark.parametrize("decoder_type", ["stateless", "rwkv"])
def test_transducer_loss_and_gradients_match_jax(decoder_type):
    jmodel, variables, tmodel = _models(decoder_type)
    batch = _batch(1)
    jargs = [jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS]

    def j_loss(params):
        loss, stats, _ = jmodel.apply({**variables, "params": params}, *jargs,
                                      deterministic=False)
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    tmodel.train()
    tmodel.zero_grad()
    before = dict(WKV_KERNEL.launches)
    loss, stats, weight = tmodel(*_torch_batch(batch).values())
    loss.backward()
    assert WKV_KERNEL.launches == before and float(weight) == 2.0
    assert stats.keys() == j_stats.keys() == {"loss_rnnt", "loss_ctc", "loss"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_speech2text_dispatches_a_transducer():
    """beam_size > 1 runs the beam search, 1 the greedy decode; every other
    search of the JAX package dispatches too (held against JAX in
    tests/test_torch_transducer_extra.py), and the LSTM and MEGA decoders
    build."""
    _, _, tmodel = _models("rwkv")
    wave = _batch(5)["speech"][0, :1500]
    with torch.no_grad():
        enc, lens = tmodel.eval().encode(torch.from_numpy(np.pad(wave, (0, 100)))[None],
                                         torch.tensor([1500]))
        greedy_tok, greedy_n = ttd.transducer_greedy_decode(tmodel, enc, lens)
        beam = transducer_beam_decode(tmodel, enc, lens, beam_size=3)
    (ids, hyp), = Speech2Text.from_model(tmodel, beam_size=1)(wave)
    assert hyp.yseq == greedy_tok[0, : greedy_n[0]].tolist()
    assert ids == [i for i in hyp.yseq if i != VOCAB - 1]  # sos = eos = V-1 dropped, as in JAX
    (ids, hyp), = Speech2Text.from_model(tmodel, beam_size=3)(wave)
    assert hyp.yseq == beam[0].yseq and hyp.score == pytest.approx(beam[0].score)
    for search in ("alsd", "tsd", "nsc", "mbg"):
        (_, hyp), = Speech2Text.from_model(tmodel, beam_size=3, transducer_search=search)(wave)
        assert math.isfinite(hyp.score)
    for decoder_type in ("rnn", "mega"):
        model = ttd.TransducerModel(_configs(decoder_type)[1], device="cpu")
        assert model.decoder.cfg.decoder_type == decoder_type


def test_init_weights_covers_the_transducer():
    """The benchmark's fill rule reaches the RWKV leaves: the mixes, the
    decay and the bonus are weights (N(0, 0.02)), the bare LayerNorms 1 and
    0, the joint's biases 0; the same seed gives the same weights."""
    from llm_guided_asr_tpu_torch.convert import init_weights

    tcfg = _configs("rwkv")[1]
    model = init_weights(ttd.TransducerModel(tcfg, device="cpu"), seed=3)
    att = model.decoder.block_0.att
    for p in (att.mu_k, att.time_decay, att.time_first, model.decoder.block_0.ffn.mu_r):
        assert 0.005 < float(p.detach().std()) < 0.05
    assert torch.all(model.decoder.ln_in.weight == 1) and torch.all(model.decoder.ln_out.bias == 0)
    assert torch.all(model.joint.lin_out.bias == 0)
    again = init_weights(ttd.TransducerModel(tcfg, device="cpu"), seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
