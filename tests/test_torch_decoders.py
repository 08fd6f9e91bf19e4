"""Port vs JAX, the other decoders of the CTC/attention model: ``rnn``
(location-aware attention and LSTM cells), ``lightconv`` and
``dynamicconv`` (causal convolution decoders) and ``s4`` (the S4D and the
NPLR kernels), from the same weights carried across by params_from_jax
(``strict=True``).

Tiny shapes (encoder rows [3, 9, 16] with lengths 9, 6, 4; labels [3, 5]
with lengths 5, 3, 1; vocab 12; one block, two LSTM layers), every
dropout at 0, float32:

- each decoder's logits over every position and at the last one
  (``only_last``), and the gradient of sum(logits * r) for every
  parameter, rtol/atol 1e-4; ``hippo_legs_dplr`` against JAX's (1e-5);
- an ``ASRModel`` with the dynamicconv decoder over the Whisper-style
  encoder: stats and every gradient;
- ``build_model_config`` against JAX's for each decoder and encoder
  choice, and the port's model built from it;
- JAX-written experiment directories with ``decoder: rnn`` and
  ``decoder: s4``: the port's Speech2Text gives JAX's beam-3 n-best from
  the stateless scorer, its ``asr_inference`` writes JAX's 1-best text
  (rnn), and the cached decoder refuses both (JAX's raises KeyError at its
  first decode);
- the new decoders take the card by default and raise without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_inference as jinference
from llm_guided_asr_tpu.data.fileio import write_wav
from llm_guided_asr_tpu.models import rnn_decoder as jrnn
from llm_guided_asr_tpu.models import s4_decoder as js4
from llm_guided_asr_tpu.models import transformer_decoder as jtd
from llm_guided_asr_tpu.search.cached_decoder import CachedDecoderScorer as JCachedDecoderScorer
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu.train.checkpoint import save_pytree
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch.bin import asr_inference as tinference
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import rnn_decoder as trnn
from llm_guided_asr_tpu_torch.models import s4_decoder as ts4
from llm_guided_asr_tpu_torch.models import transformer_decoder as ttd
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel
from llm_guided_asr_tpu_torch.search.scorers import StatelessAttScorer
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from test_torch_branchformer import TOKENS, _fast_jax_init, _load
from test_torch_task_guided import _same_fields
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, _batch, _np, _torch_batch, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

D, VOCAB = 16, 12
N_FEATS = 20
DEC = dict(attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_DEC)
ENC = dict(output_size=D, attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_ENC)


def _assert_grads(module, j_grads):
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in module.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _inputs():
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((3, 9, D)).astype(np.float32)
    ys = rng.integers(0, VOCAB, (3, 5)).astype(np.int32)
    return enc, np.array([9, 6, 4], np.int32), ys, np.array([5, 3, 1], np.int32)


def _modules(kind):
    """(JAX decoder, port decoder) at the tiny widths."""
    if kind == "rnn":
        cfg = dict(vocab_size=VOCAB, hidden=12, layers=2, embed_dim=8, att_dim=D)
        return (jrnn.RNNDecoder(jrnn.RNNDecoderConfig(**cfg)),
                trnn.RNNDecoder(trnn.RNNDecoderConfig(**cfg), D, device="cpu"))
    if kind in ("lightconv", "dynamicconv"):
        dynamic = kind == "dynamicconv"
        return (jtd.ConvTransformerDecoder(VOCAB, jtd.TransformerDecoderConfig(**DEC),
                                           dynamic=dynamic),
                ttd.ConvTransformerDecoder(VOCAB, ttd.TransformerDecoderConfig(**DEC), D,
                                           dynamic=dynamic, device="cpu"))
    cfg = dict(vocab_size=VOCAB, d_model=D, d_state=8, n_layers=1, attention_heads=2,
               linear_units=24, kernel=kind.split("-")[1])
    return (js4.S4Decoder(js4.S4DecoderConfig(**cfg)),
            ts4.S4Decoder(ts4.S4DecoderConfig(**cfg), device="cpu"))


@pytest.mark.parametrize("kind", ["rnn", "lightconv", "dynamicconv", "s4-diag", "s4-nplr"])
def test_decoder_matches_jax(kind):
    jdec, tdec = _modules(kind)
    inputs = _inputs()
    jargs = [jnp.asarray(x) for x in inputs]
    variables = seeded_variables(jdec, *jargs, seed=1)
    r = np.random.default_rng(2).standard_normal((3, 5, VOCAB)).astype(np.float32)

    def j_loss(params):
        logits = jdec.apply({"params": params}, *jargs, deterministic=False)
        last = jdec.apply({"params": params}, *jargs, only_last=True)
        return jnp.sum(logits * r), (logits, last)

    (_, (j_logits, j_last)), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    _load(tdec, variables).train()
    targs = [torch.from_numpy(x) if x.dtype == np.float32 else torch.from_numpy(x).long()
             for x in inputs]
    logits = tdec(*targs)
    with torch.no_grad():
        last = tdec.eval()(*targs, only_last=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(j_last), rtol=1e-4, atol=1e-4)
    (logits * torch.from_numpy(r)).sum().backward()
    _assert_grads(tdec, j_grads)


@pytest.mark.parametrize("n", [4, 16, 64])
def test_hippo_legs_dplr_matches_jax(n):
    for got, want in zip(ts4.hippo_legs_dplr(n), js4.hippo_legs_dplr(n)):
        assert got.dtype == want.dtype == np.complex64
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the ASRModel and the task layer
# ---------------------------------------------------------------------------

def _task_config(root, encoder="transformer", decoder="rnn", **over):
    (root / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
    enc = dict(ENC, pos_enc_layer_type="abs_pos") if encoder in ("transformer",) else dict(ENC)
    if encoder == "s4":
        enc.update(ss_layers="s4d,ff", ss_d_state=8)
    return {**jasr.ASRTask.get_default_config(),
            "token_type": "char", "token_list": str(root / "tokens.txt"),
            "frontend_conf": {"n_fft": 128, "hop_length": 64, "n_mels": N_FEATS},
            "normalize": "utterance_mvn", "encoder": encoder, "encoder_conf": enc,
            "decoder": decoder, "decoder_conf": DEC, "model_conf": {"ctc_weight": 0.3}, **over}


def test_asr_model_with_dynamicconv_decoder_and_whisper_encoder_matches_jax(tmp_path):
    """Training mode at dropout 0: the loss, its parts and the accuracy, and
    every parameter's gradient."""
    config = _task_config(tmp_path, "whisper_style", "dynamicconv")
    jmodel = jasr.build_model(config)
    tmodel = tasr.build_model(config, "cpu")
    batch = _batch(np.random.default_rng(1))
    jargs = [jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS]
    variables = seeded_variables(jmodel, *jargs, seed=3)

    def j_loss(params):
        loss, stats, _ = jmodel.apply({**variables, "params": params}, *jargs,
                                      deterministic=False)
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    _load(tmodel, variables).train()
    loss, stats, _ = tmodel(*_torch_batch(batch).values())
    loss.backward()
    assert stats.keys() == j_stats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    _assert_grads(tmodel, j_grads)


@pytest.mark.parametrize("choice", [
    ("transformer", "rnn"), ("transformer", "s4"), ("transformer", "lightconv"),
    ("transformer", "dynamicconv"), ("multiconvformer", "transformer"),
    ("rnn", "transformer"), ("vgg_rnn", "transformer"), ("longformer", "transformer"),
    ("whisper_style", "transformer"), ("s4", "transformer")], ids="-".join)
def test_build_model_config_matches_jax_for_each_choice(tmp_path, choice):
    """The config of each new encoder and decoder equals JAX's field for
    field (``ss_layers`` from JAX's comma-separated string), and the port
    builds its model from it."""
    config = _task_config(tmp_path, *choice)
    got = tasr.build_model_config(config)
    _same_fields(got, jasr.build_model_config(config))
    assert ASRModel(got, device="cpu").cfg == got


# ---------------------------------------------------------------------------
# JAX-written experiment directories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decoder", ["rnn", "s4"])
def test_port_decodes_a_jax_directory(tmp_path, monkeypatch, decoder):
    """A JAX-written experiment directory (config.yaml by the JAX package's
    dump_yaml, its variables as a .msgpack), beam 3, ctc_weight 0.3, an
    8-token cap: the port's Speech2Text of the directory, served by the
    stateless scorer, gives JAX's 3-best (token sequences equal, scores
    within 1e-4); for ``rnn`` the port's asr_inference (``--device cpu``)
    writes JAX's 1-best text.  JAX's cached decoder raises KeyError at its
    first step on these decoders; the port's refuses them up front."""
    monkeypatch.setattr(jasr, "init_model_variables", _fast_jax_init)
    config = _task_config(tmp_path, "transformer", decoder)
    jconfig.dump_yaml(config, tmp_path / "config.yaml")
    jmodel = jasr.build_model(config)
    batch = _batch(np.random.default_rng(0))
    variables = seeded_variables(jmodel, *(jnp.asarray(batch[k])
                                           for k in jtrainer.DEFAULT_BATCH_ARGS), seed=6)
    save_pytree(tmp_path / "model.msgpack", variables)
    wave = (np.random.default_rng(7).standard_normal(4000) * 0.5).astype(np.float32)
    write_wav(tmp_path / "u0.wav", 16000, wave)
    (tmp_path / "wav.scp").write_text(f"u0 {tmp_path / 'u0.wav'}\n")
    files = (str(tmp_path / "config.yaml"), str(tmp_path / "model.msgpack"))
    decode = dict(beam_size=3, ctc_weight=0.3, nbest=3, maxlenratio=-8.0)
    jspeech = jinference.Speech2Text(*files, **decode)
    want = jspeech(wave)
    s2t = tinference.Speech2Text(*files, **decode, device="cpu")
    assert isinstance(s2t.beam.att_scorer, StatelessAttScorer)
    got = s2t(wave)
    assert len(got) == len(want) == 3 and any(ids for _, _, ids, _ in got)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert [g[3].yseq for g in got] == [w[3].yseq for w in want]
    np.testing.assert_allclose([g[3].score for g in got], [w[3].score for w in want],
                               rtol=1e-4, atol=1e-4)
    if decoder == "rnn":
        tinference.main(["--asr_train_config", files[0], "--asr_model_file", files[1],
                         "--data_path_and_name_and_type", f"{tmp_path / 'wav.scp'},speech,sound",
                         "--output_dir", str(tmp_path / "tdec"), "--device", "cpu",
                         "--beam_size", "3", "--ctc_weight", "0.3", "--maxlenratio", "-8"])
        text = (tmp_path / "tdec" / "1best_recog" / "text").read_text().split(maxsplit=1)
        assert text[0] == "u0" and text[1:] == ([want[0][0] + "\n"] if want[0][0] else [])
    jscorer = JCachedDecoderScorer(jspeech.model, jspeech.variables, 2, 2)
    with pytest.raises(KeyError, match="block_0"):
        jscorer.init(jnp.zeros((1, 4, D)), jnp.asarray([4]), 3, 8)
    with pytest.raises(ValueError, match="transformer decoder only"):
        tinference.Speech2Text.from_model(s2t.model, ctc_weight=0.3, beam_size=3,
                                          use_cached_decoder=True)


def test_new_decoders_require_a_card_by_default(monkeypatch):
    """No silent CPU fallback: without ``device`` the decoders take the card
    and raise on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: trnn.RNNDecoder(trnn.RNNDecoderConfig(), D),
                  lambda: ts4.S4Decoder(ts4.S4DecoderConfig()),
                  lambda: ttd.ConvTransformerDecoder(VOCAB, ttd.TransformerDecoderConfig(), D)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
