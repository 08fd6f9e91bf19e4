"""Port vs JAX, the CTC/attention model over pretrained Hugging Face
trunks, built from task configs by both packages' ``build_model`` and
carried across by params_from_jax (``strict=True``; the trunks' weights
are the tiny random directories' as each package's loader reads them):

- ``frontend: ssl`` (a frozen HuBERT) + the Conformer with its conv2d
  input layer: loss (rtol 2e-4), every gradient (1e-4 * max|ref|), no
  gradient reaching the trunk, one AdamW step with weight decay (the
  trunk decays under AdamW in both: JAX freezes it by ``stop_gradient``
  alone), and a beam-10 decode's 10-best token for token, scores at 1e-4;
- ``encoder: hubert_hf`` (raw waveform, the trunk trains) and
  ``encoder: whisper_hf`` (log-mel frames): loss and every gradient.

A gradient that misses JAX's float32 one is checked in float64 instead:
JAX's model cloned with ``dtype=float64`` under ``jax.enable_x64`` on the
same variables, against the port's model cast to float64, at the same
tolerance, and the port's float32 gradient within it of its float64 one.
JAX's x64 run keeps its CTC log-softmax and its attention softmaxes in
float32 (``astype(jnp.float32)``), so the two float64 gradients agree
only to that rounding; the port's run is float64 throughout.  On the
tiny random HuBERT trunk (``hubert_hf``) the last LayerNorm scale misses
JAX's float32 gradient by 1.03 x the tolerance; the float64 gradients
part by 0.59 x, the port's float32 is 0.71 x from its float64.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_guided_asr_tpu.models import ssl_encoders as jssl
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer
from test_torch_branchformer import _np
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

TOKENS = ["<blank>", "<unk>"] + list("abcdefghi") + ["<sos/eos>"]
VOCAB = len(TOKENS)
SOS = EOS = VOCAB - 1
TINY_W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=48, conv_dim=[16, 16], conv_kernel=[10, 3], conv_stride=[5, 2],
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
# one Conformer block: the tests are about the trunks before it, and XLA
# compiles each JAX step in about half the time of two blocks
ENC = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1,
           cnn_module_kernel=7, **NO_DROP_ENC)
DEC = dict(attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_DEC)
N_SAMPLES = 3000  # padded to 3200 by Speech2Text


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import HubertConfig, HubertModel, WhisperConfig, WhisperModel

    root = tmp_path_factory.mktemp("hf_asr")
    torch.manual_seed(0)
    HubertModel(HubertConfig(**TINY_W2V)).save_pretrained(root / "hubert")
    torch.manual_seed(1)
    WhisperModel(WhisperConfig(
        d_model=16, encoder_layers=1, encoder_attention_heads=2, encoder_ffn_dim=24,
        num_mel_bins=12, max_source_positions=64, decoder_layers=1, decoder_attention_heads=2,
        decoder_ffn_dim=24)).save_pretrained(root / "whisper")
    return root


def configs(root):
    base = {"token_list": TOKENS, "normalize": "utterance_mvn", "encoder_conf": dict(ENC),
            "decoder_conf": dict(DEC), "model_conf": {"ctc_weight": 0.3}}
    return {
        "ssl": {**base, "frontend": "ssl",
                "frontend_conf": {"model_name_or_path": str(root / "hubert"), "kind": "hubert"}},
        "hubert_hf": {**base, "frontend": "none", "normalize": "none", "encoder": "hubert_hf",
                      "encoder_conf": {"model_name_or_path": str(root / "hubert"),
                                       "output_size": 16}},
        "whisper_hf": {**base, "frontend_conf": {"n_fft": 128, "hop_length": 64, "n_mels": 12},
                       "encoder": "whisper_hf",
                       "encoder_conf": {"model_name_or_path": str(root / "whisper"),
                                        "output_size": 16}},
    }


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    speech = (rng.standard_normal((2, 3200)) * 0.5).astype(np.float32)
    text = np.array([[2, 3, 4, 5], [6, 7, -1, -1]], np.int32)
    return (speech, np.array([3200, 2300], np.int32), text, np.array([4, 2], np.int32))


def _torch(args):
    return tuple(torch.from_numpy(a) if a.dtype == np.float32 else torch.from_numpy(a).long()
                 for a in args)


def jax_variables(jmodel, config):
    """Seeded variables (no flax init compile) with the pretrained trunk
    of the config's directory as JAX's init_model_variables injects it."""
    variables = seeded_variables(jmodel, *(jnp.asarray(a) for a in _batch()), seed=5)
    params = dict(variables["params"])
    if config.get("frontend") == "ssl":
        fc = config["frontend_conf"]
        params["ssl_frontend"] = jssl.load_pretrained_encoder(fc["model_name_or_path"],
                                                              fc["kind"])[1]
    if config.get("encoder", "").endswith("_hf"):
        name = config["encoder_conf"]["model_name_or_path"]
        params["encoder"] = {**params["encoder"], "ssl": jssl.load_pretrained_encoder(
            name, config["encoder"][: -len("_hf")])[1]}
    return {**variables, "params": params}


@functools.lru_cache(maxsize=None)
def _models(kind, root):
    config = {**jasr.ASRTask.get_default_config(), **configs(root)[kind]}
    jmodel = jasr.build_model(config)
    variables = jax_variables(jmodel, config)
    tmodel = tasr.build_model(config, "cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return config, jmodel, variables, tmodel


@functools.lru_cache(maxsize=None)
def _jax_grads(kind, root):
    _, jmodel, variables, _ = _models(kind, root)
    jargs = [jnp.asarray(a) for a in _batch(1)]

    def j_loss(params):
        (loss, stats, _), _ = jmodel.apply({**variables, "params": params}, *jargs,
                                           deterministic=False, mutable=["batch_stats"])
        return loss, stats

    (_, stats), grads = jit(jax.value_and_grad(j_loss, has_aux=True))(variables["params"])
    return stats, grads


@pytest.mark.parametrize("kind", ["ssl", "hubert_hf", "whisper_hf"])
def test_loss_and_gradients_match_jax(hf_dirs, kind):
    """Training mode, dropout off: the stats at rtol 2e-4, every gradient
    at 1e-4 of its largest value plus 1e-6 of the model's largest (a bias
    before a batch norm is rounding noise in both); the frozen SSL trunk
    gets none in the port and zeros in JAX."""
    j_stats, j_grads = _jax_grads(kind, hf_dirs)
    model = copy.deepcopy(_models(kind, hf_dirs)[3]).train()
    loss, stats, _ = model(*_torch(_batch(1)))
    loss.backward()
    assert stats.keys() == j_stats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=2e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-6 * max(float(r.abs().max()) for r in want.values())
    exact = None
    for name, g in got.items():
        ref = want[name].numpy()
        if name.startswith("ssl_frontend."):
            assert g is None and not ref.any(), name
            continue
        tol = 1e-4 * np.abs(ref).max() + floor
        miss = np.abs(g.numpy() - ref).max()
        if miss > tol:
            # float32 rounding: both packages in float64 agree, and the
            # port's float32 gradient is its float64 one to the tolerance
            exact = exact or (_jax_float64_grads(kind, hf_dirs), _float64_grads(model, kind))
            j64, t64 = exact[0][name], exact[1][name]
            assert np.abs(t64 - j64).max() <= tol, name
            assert np.abs(g.numpy() - t64).max() <= tol, name
    if kind == "ssl":
        assert not model.ssl_frontend.training  # the trunk stays in eval mode


@functools.lru_cache(maxsize=None)
def _jax_float64_grads(kind, root):
    """JAX's gradients of batch 1 with the model and its variables in
    float64 (x64 on for this call alone), on the port's names
    (params_from_jax rounds them to float32: 1e-3 of the tolerance)."""
    _, jmodel, variables, _ = _models(kind, root)
    with jax.enable_x64(True):
        model = jmodel.clone(dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64) if a.dtype == jnp.float32 else a),
            variables)
        jargs = [jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)
                 for a in _batch(1)]

        def loss(params):
            (out, _, _), _ = model.apply({**v64, "params": params}, *jargs, deterministic=False,
                                         mutable=["batch_stats"])
            return out

        grads = jax.tree_util.tree_map(np.asarray, jit(jax.grad(loss))(v64["params"]))
    return {n: g.numpy().astype(np.float64)
            for n, g in params_from_jax({"params": grads}).items()}


def _float64_grads(model, kind):
    """The port's gradients of batch 1 in float64."""
    m = copy.deepcopy(model).double().train()
    m.zero_grad(set_to_none=True)
    args = tuple(a.double() if a.is_floating_point() else a for a in _torch(_batch(1)))
    m(*args)[0].backward()
    return {n: p.grad.numpy() for n, p in m.named_parameters() if p.grad is not None}


def test_one_adamw_step_decays_the_frozen_trunk_as_jax(hf_dirs):
    """The port's fused AdamW step (weight decay 0.1) against optax's AdamW
    applied to JAX's gradient: every parameter at 1e-5, the SSL trunk's
    included, which both decay although no gradient reaches it."""
    _, _, variables, tmodel = _models("ssl", hf_dirs)
    j_stats, j_grads = _jax_grads("ssl", hf_dirs)
    conf = {"lr": 1e-3, "eps": 1e-3, "weight_decay": 0.1}
    tx = joptim.build_optimizer("adamw", dict(conf))

    @jax.jit
    def update(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    params = update(variables["params"], j_grads)
    model = copy.deepcopy(tmodel)
    state = ttrainer.init_train_state(model, toptim.build_optimizer("adamw", dict(conf)))
    names = jtrainer.DEFAULT_BATCH_ARGS
    t_stats, _ = ttrainer.make_fused_train_step(model, state, torch.Generator().manual_seed(0))(
        dict(zip(names, _torch(_batch(1)))))
    np.testing.assert_allclose(float(t_stats["loss"]), float(j_stats["loss"]), rtol=2e-4)
    want = params_from_jax({"params": _np(params)})
    before = tmodel.state_dict()
    got = model.state_dict()
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), ref.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    w = "ssl_frontend.layers_0.attention.q_proj.weight"
    np.testing.assert_allclose(got[w].numpy(), (before[w] * (1 - 1e-3 * 0.1)).numpy(),
                               rtol=1e-6, atol=1e-9)


def test_beam10_nbest_matches_jax(hf_dirs):
    """frontend: ssl, beam 10, ctc_weight 0.3, an 8-token cap: JAX's
    BatchBeamSearch over JAX's encoder output of the request as
    Speech2Text pads it, and the port's Speech2Text: the same 10-best,
    token for token, scores at 1e-4."""
    _, jmodel, variables, tmodel = _models("ssl", hf_dirs)
    speech = (np.random.default_rng(11).standard_normal(N_SAMPLES) * 0.5).astype(np.float32)
    padded = np.zeros((1, 3200), np.float32)
    padded[0, :N_SAMPLES] = speech
    enc, enc_lens = jit(functools.partial(jmodel.apply, method=jmodel.encode))(
        variables, jnp.asarray(padded), jnp.asarray([N_SAMPLES], jnp.int32))
    j_hyps = JBeamSearch(jmodel, variables, vocab_size=VOCAB, sos=SOS, eos=EOS, beam_size=10,
                         ctc_weight=0.3)(enc, enc_lens, maxlenratio=-8.0, nbest=10)
    s2t = Speech2Text.from_model(tmodel.eval(), ctc_weight=0.3, beam_size=10, nbest=10,
                                 maxlenratio=-8.0)
    out = s2t(speech)
    assert len(out) == len(j_hyps) == 10
    assert [h.yseq for _, h in out] == [h.yseq for h in j_hyps]
    np.testing.assert_allclose([h.score for _, h in out], [h.score for h in j_hyps], rtol=1e-4)
