"""Port vs JAX, the E-Branchformer, Branchformer and Transformer encoders,
the ``linear``/``none`` input layers, and ``tie_input_output``, from the
same weights carried across by params_from_jax (``strict=True``).

Tiny shapes (2 blocks, D = 32, 2 heads, linear_units 64, kernel 7;
features [3, 57, 20] with ragged lengths), every dropout at 0, float32:

- the cgMLP against JAX's in eval;
- each new encoder under ``conv2d``, ``linear`` and ``none`` (``none``
  keeps the 20 features, so JAX's parameter shapes decide the width):
  outputs in training mode, and under ``conv2d`` every parameter's
  gradient, rtol/atol 1e-4 (the other input layers at one block); the
  Conformer under ``linear`` and ``none`` in eval;
- an ``ASRModel`` with ``encoder: e_branchformer``, ``tie_input_output``
  and intermediate-CTC taps asked for (the E-Branchformer gives none, so
  there is no ``loss_interctc``, as in JAX): stats and gradients;
- ``ASRTask`` building each new encoder from YAML with JAX's parameter
  tree;
- a JAX-written tied E-Branchformer experiment directory (config.yaml +
  .msgpack): the port's Speech2Text of it, on the stateless scorer, gives
  JAX's beam-4 n-best; its ``asr_inference`` writes JAX's 1-best text; its
  cached decoder refuses the tied model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_inference as jinference
from llm_guided_asr_tpu.data.fileio import write_wav
from llm_guided_asr_tpu.models import branchformer as jbf
from llm_guided_asr_tpu.models import conformer as jconf
from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JDecoderConfig,
)
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu.train.checkpoint import save_pytree
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch.bin import asr_inference as tinference
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.branchformer import (
    BranchformerEncoder,
    ConvolutionalGatingMLP,
    EBranchformerEncoder,
)
from llm_guided_asr_tpu_torch.models.conformer import (
    ConformerConfig,
    TransformerEncoder,
    make_encoder,
)
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.search.scorers import StatelessAttScorer
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, _batch, _np, _torch_batch, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

N_FEATS = 20
# one decoder block: the tests are about the encoders (two blocks where a
# test takes every gradient) and the tied output layer
ENC = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
           cnn_module_kernel=7, **NO_DROP_ENC)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=1, tie_input_output=True, **NO_DROP_DEC)
J_ENCODERS = {"e_branchformer": jbf.EBranchformerEncoder, "branchformer": jbf.BranchformerEncoder,
              "transformer": jconf.TransformerEncoder, "conformer": jconf.ConformerEncoder}
T_ENCODERS = {"e_branchformer": EBranchformerEncoder, "branchformer": BranchformerEncoder,
              "transformer": TransformerEncoder}
VOCAB = 12
TOKENS = ["<blank>", "<unk>", "a", "b", "c", "d", "e", "f", "g", "h", "i", "<sos/eos>"]


def _feats():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 57, N_FEATS)).astype(np.float32),
            np.array([57, 40, 23], np.int32))


def _load(module, variables):
    module.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return module


def test_cgmlp_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 19, 32)).astype(np.float32)
    valid = np.arange(19)[None] < np.array([[19], [12], [5]])
    jmod = jbf.ConvolutionalGatingMLP(64, 7, 0.0)
    variables = seeded_variables(jmod, jnp.asarray(x), jnp.asarray(valid), seed=1)
    want = jit(jmod.apply)(variables, jnp.asarray(x), jnp.asarray(valid))
    tmod = _load(ConvolutionalGatingMLP(32, 64, 7, 0.0), variables).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("input_layer", ["conv2d", "linear", "none"])
@pytest.mark.parametrize("kind", ["e_branchformer", "branchformer", "transformer"])
def test_encoder_matches_jax(kind, input_layer):
    """Training mode at dropout 0: the output (pads zeroed) and the lengths;
    under ``conv2d`` also the gradient of sum(out * r) for every parameter.
    The other input layers take one block: one gradient compile and
    short forward compiles keep the file's time."""
    feats, lens = _feats()
    with_grads = input_layer == "conv2d"
    cfg = dict(ENC, input_layer=input_layer, num_blocks=2 if with_grads else 1)
    jmod = J_ENCODERS[kind](jconf.ConformerConfig(**cfg))
    jargs = (jnp.asarray(feats), jnp.asarray(lens))
    variables = seeded_variables(jmod, *jargs, seed=2)
    out_shape = jax.eval_shape(jmod.apply, variables, *jargs)[0].shape
    r = np.random.default_rng(3).standard_normal(out_shape).astype(np.float32)

    def j_loss(params):
        out, out_lens = jmod.apply({"params": params}, *jargs, deterministic=False)
        return jnp.sum(out * r), (out, out_lens)

    if with_grads:
        (_, (j_out, j_lens)), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
            variables["params"])
    else:
        _, (j_out, j_lens) = jit(j_loss)(variables["params"])
    tmod = make_encoder(kind, ConformerConfig(**cfg), N_FEATS, device="cpu")
    assert isinstance(tmod, T_ENCODERS[kind])
    _load(tmod, variables).train()
    out, out_lens = tmod(torch.from_numpy(feats), torch.from_numpy(lens).long())
    width = N_FEATS if input_layer == "none" else ENC["output_size"]
    assert tmod.output_size == width == out.shape[-1]
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-4)
    if not with_grads:
        return
    (out * torch.from_numpy(r)).sum().backward()
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("input_layer", ["linear", "none"])
def test_conformer_input_layers_match_jax(input_layer):
    """The Conformer's ``linear`` and ``none`` input layers, in eval (batch
    norms on their seeded running statistics), one block."""
    feats, lens = _feats()
    cfg = dict(ENC, input_layer=input_layer, macaron_style=True, num_blocks=1)
    jmod = jconf.ConformerEncoder(jconf.ConformerConfig(**cfg))
    jargs = (jnp.asarray(feats), jnp.asarray(lens))
    variables = seeded_variables(jmod, *jargs, seed=4)
    j_out, j_lens = jit(jmod.apply)(variables, *jargs)
    tmod = _load(make_encoder("conformer", ConformerConfig(**cfg), N_FEATS, device="cpu"),
                 variables).eval()
    with torch.no_grad():
        out, out_lens = tmod(torch.from_numpy(feats), torch.from_numpy(lens).long())
    assert tmod.output_size == out.shape[-1] == j_out.shape[-1]
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-4)


def test_unknown_input_layer_raises():
    """JAX's Transformer and E-Branchformer take an unknown input layer
    as ``none``; the port refuses it."""
    with pytest.raises(ValueError, match="input_layer"):
        make_encoder("e_branchformer", ConformerConfig(**dict(ENC, input_layer="conv2d6")),
                     N_FEATS, device="cpu")


# ---------------------------------------------------------------------------
# the ASRModel: e_branchformer, tie_input_output
# ---------------------------------------------------------------------------

def test_ebranchformer_tied_asr_model_loss_and_gradients_match_jax():
    common = dict(vocab_size=VOCAB, normalize="utterance_mvn", ctc_weight=0.3,
                  encoder_type="e_branchformer", interctc_weight=0.3)
    enc = dict(ENC, interctc_layer_idx=(1,))
    front = dict(n_fft=128, hop_length=64, n_mels=N_FEATS)
    jmodel = JASRModel(JASRModelConfig(frontend=JFrontendConfig(**front),
                                       encoder=jconf.ConformerConfig(**enc),
                                       decoder=JDecoderConfig(**DEC), **common))
    variables = seeded_variables(jmodel, *(jnp.asarray(_batch(np.random.default_rng(0))[k])
                                           for k in jtrainer.DEFAULT_BATCH_ARGS), seed=5)
    tmodel = _load(ASRModel(ASRModelConfig(frontend=FrontendConfig(**front),
                                           encoder=ConformerConfig(**enc),
                                           decoder=TransformerDecoderConfig(**DEC), **common),
                            device="cpu"), variables)
    assert "output_layer" not in variables["params"]["decoder"]
    assert not hasattr(tmodel.decoder, "output_layer")
    batch = _batch(np.random.default_rng(1))
    jargs = [jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS]

    def j_loss(params):
        loss, stats, _ = jmodel.apply({**variables, "params": params}, *jargs,
                                      deterministic=False)
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    tmodel.train()
    loss, stats, _ = tmodel(*_torch_batch(batch).values())
    loss.backward()
    # no intermediate taps from the E-Branchformer: no loss_interctc in either
    assert stats.keys() == j_stats.keys() and "loss_interctc" not in stats
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the task layer
# ---------------------------------------------------------------------------

def _task_config(root, encoder):
    (root / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
    return {**jasr.ASRTask.get_default_config(),
            "token_type": "char", "token_list": str(root / "tokens.txt"),
            "frontend_conf": {"n_fft": 128, "hop_length": 64, "n_mels": N_FEATS},
            "normalize": "utterance_mvn", "encoder": encoder,
            "encoder_conf": dict(ENC, pos_enc_layer_type="abs_pos")
            if encoder == "transformer" else ENC,
            "decoder_conf": DEC, "model_conf": {"ctc_weight": 0.3}}


@pytest.mark.parametrize("encoder", ["transformer", "e_branchformer", "branchformer"])
def test_asr_task_builds_each_encoder_from_yaml(tmp_path, encoder):
    """The YAML the JAX package writes builds the port's model, whose state
    dict has JAX's parameter tree: every name and shape."""
    config = _task_config(tmp_path, encoder)
    jconfig.dump_yaml(config, tmp_path / "config.yaml")
    model = tasr.ASRTask.build_model_from_file(tmp_path / "config.yaml", None, "cpu")[0]
    assert isinstance(model.encoder, {"transformer": TransformerEncoder,
                                      **T_ENCODERS}[encoder])
    jmodel = jasr.build_model(config)
    batch = _batch(np.random.default_rng(0))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS))
    want = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in got)


def _fast_jax_init(model, config, seed=0):
    """Stand-in for the JAX task's init_model_variables (eager flax init
    of a model, ~25 s here): zeros of its shapes, which the .msgpack then
    replaces leaf for leaf."""
    batch = _batch(np.random.default_rng(0))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            *(jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def test_port_decodes_a_jax_ebranchformer_directory(tmp_path, monkeypatch):
    """A JAX-written experiment directory of a tied E-Branchformer model
    (config.yaml by the JAX package's dump_yaml, its variables as a
    .msgpack), beam 4, ctc_weight 0.3, an 8-token cap: the port's
    Speech2Text of the directory, served by the stateless scorer, gives
    JAX's 4-best (token sequences equal, scores within 1e-4); the port's
    asr_inference (``--device cpu``) writes JAX's 1-best text and tokens;
    the port's cached decoder refuses the tied model."""
    monkeypatch.setattr(jasr, "init_model_variables", _fast_jax_init)
    config = {**_task_config(tmp_path, "e_branchformer"),
              "model_conf": {"ctc_weight": 0.3, "interctc_weight": 0.3}}
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
    decode = dict(beam_size=4, ctc_weight=0.3, nbest=4, maxlenratio=-8.0)
    want = jinference.Speech2Text(*files, **decode)(wave)
    s2t = tinference.Speech2Text(*files, **decode, device="cpu")
    assert isinstance(s2t.beam.att_scorer, StatelessAttScorer)
    got = s2t(wave)
    assert len(got) == len(want) == 4 and any(ids for _, _, ids, _ in got)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert [g[3].yseq for g in got] == [w[3].yseq for w in want]
    np.testing.assert_allclose([g[3].score for g in got], [w[3].score for w in want],
                               rtol=1e-4, atol=1e-4)
    tinference.main(["--asr_train_config", files[0], "--asr_model_file", files[1],
                     "--data_path_and_name_and_type", f"{tmp_path / 'wav.scp'},speech,sound",
                     "--output_dir", str(tmp_path / "tdec"), "--device", "cpu",
                     "--beam_size", "4", "--ctc_weight", "0.3", "--maxlenratio", "-8"])
    text = (tmp_path / "tdec" / "1best_recog" / "text").read_text().split(maxsplit=1)
    assert text[0] == "u0" and text[1:] == ([want[0][0] + "\n"] if want[0][0] else [])
    with pytest.raises(ValueError, match="tie_input_output"):
        tinference.Speech2Text.from_model(s2t.model, ctc_weight=0.3, beam_size=4,
                                          use_cached_decoder=True)


def test_new_encoders_require_a_card_by_default(monkeypatch):
    """No silent CPU fallback: without ``device`` the encoders take the card
    and raise on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("transformer", "e_branchformer", "branchformer"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_encoder(kind, ConformerConfig(**ENC), N_FEATS)


def test_guided_model_takes_the_encoders_width_under_input_layer_none():
    """The LLM-guided model over an E-Branchformer with ``input_layer:
    none``: the CTC head and the guided decoder's cross-attention read the
    encoder's 24 features while the decoder stays ``output_size`` (32)
    wide, as JAX's parameter shapes have it; the loss equals JAX's."""
    from llm_guided_asr_tpu.models import llm_guided as jlg
    from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
    from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
    from llm_guided_asr_tpu_torch.models import llm_guided as tlg
    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
    from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate

    llm = dict(vocab_size=50, hidden_size=32, intermediate_size=48, num_hidden_layers=1,
               num_attention_heads=4, num_key_value_heads=2)
    prompt = dict(prefix_ids=(2, 3, 4), suffix_ids=(5, 6), start_of_response_id=7,
                  end_of_response_id=7, pad_id=0)
    common = dict(vocab_size=50, normalize="utterance_mvn", ctc_weight=0.3,
                  encoder_type="e_branchformer")
    enc = dict(ENC, input_layer="none", num_blocks=1)
    dec = dict(DEC, tie_input_output=False, num_blocks=1)
    front = dict(n_fft=128, hop_length=64, n_mels=24)
    jmodel = jlg.LLMGuidedASRModel(jlg.LLMGuidedASRConfig(
        llm=JLlamaConfig(**llm), prompt=JPromptTemplate(**prompt),
        frontend=JFrontendConfig(**front), encoder=jconf.ConformerConfig(**enc),
        decoder=JDecoderConfig(**dec), **common))
    batch = {**_batch(np.random.default_rng(2), hi=49), "speech_lengths": np.array(
        [3200, 2500, 1600], np.int32)}
    jargs = [jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS]
    variables = seeded_variables(jmodel, *jargs, seed=8)
    j_loss, j_stats, _ = jit(jmodel.apply)(variables, *jargs)
    tmodel = _load(tlg.LLMGuidedASRModel(tlg.LLMGuidedASRConfig(
        llm=LlamaConfig(**llm), prompt=PromptTemplate(**prompt),
        frontend=FrontendConfig(**front), encoder=ConformerConfig(**enc),
        decoder=TransformerDecoderConfig(**dec), **common), llm_dtype=torch.float32,
        device="cpu"), variables).eval()
    assert tmodel.encoder.output_size == 24 and tmodel.ctc_head.in_features == 24
    assert tmodel.block_0.src_attn.linear_k.in_features == 24 and tmodel.embed.out_features == 32
    with torch.no_grad():
        loss, stats, _ = tmodel(*_torch_batch(batch).values())
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(j_stats[k]), rtol=1e-4, err_msg=k)
