"""Port vs JAX, the rest of the pretrained-directory choices of the
CTC/attention model, and every such choice through ``ASRTask`` from a YAML:

- the sinc pre-encoder over the sliding window with the length adaptor,
  the BERT post-encoder (language token, one adaptor layer), the fused
  frontend and the ``hugging_face`` decoder (a tiny Llama directory with
  its tokenizer): loss (rtol 2e-4) and every gradient (1e-4 * max|ref|)
  in eval mode, from both packages' ``build_model`` of one config;
- the ``hugging_face`` decoder's beam-10 decode: the 10-best token for
  token against JAX's BatchBeamSearch, scores at 1e-4;
- each choice from a YAML file (``ASRTask.build_model_from_file``): the
  pretrained tensors that land equal the JAX loader's of the same
  directory, one fused AdamW step gives a finite loss, Speech2Text
  decodes; ``frontend: ssl``'s ``collect_feats`` are the trunk's states;
- the choices the port lacked until the multichannel and AV-HuBERT
  slice (avhubert, the WPE/MVDR fields) build their modules
  (tests/test_torch_avhubert.py and tests/test_torch_beamformer.py hold
  them against JAX).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import hf_encoder as jhe
from llm_guided_asr_tpu.models import ssl_encoders as jssl
from llm_guided_asr_tpu.models.llm import llama as jllama
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer
from llm_guided_asr_tpu_torch.utils.config import dump_yaml
from test_torch_branchformer import _np
from test_torch_hf_asr import DEC, ENC, TINY_W2V, TOKENS, _batch, _torch
from test_torch_train import jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import (
        BertConfig,
        BertModel,
        HubertConfig,
        HubertModel,
        Wav2Vec2Config,
        Wav2Vec2Model,
        WhisperConfig,
        WhisperModel,
    )

    from llm_guided_asr_tpu.utils.testing import make_tiny_llm_dir

    root = tmp_path_factory.mktemp("hf_task")
    torch.manual_seed(0)
    Wav2Vec2Model(Wav2Vec2Config(**TINY_W2V)).save_pretrained(root / "wav2vec2")
    HubertModel(HubertConfig(**TINY_W2V)).save_pretrained(root / "hubert")
    WhisperModel(WhisperConfig(
        d_model=16, encoder_layers=1, encoder_attention_heads=2, encoder_ffn_dim=24,
        num_mel_bins=12, max_source_positions=64, decoder_layers=1, decoder_attention_heads=2,
        decoder_ffn_dim=24)).save_pretrained(root / "whisper")
    BertModel(BertConfig(vocab_size=40, hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=24,
                         max_position_embeddings=40)).save_pretrained(root / "bert")
    make_tiny_llm_dir(root / "llm", hidden_size=16, intermediate_size=24, num_layers=1,
                      num_heads=2, num_kv_heads=1)
    return root


def configs(root):
    base = {"token_list": TOKENS, "normalize": "utterance_mvn", "encoder_conf": dict(ENC),
            "decoder_conf": dict(DEC), "model_conf": {"ctc_weight": 0.3}}
    lin = dict(ENC, input_layer="linear", num_blocks=1)
    mel = {"n_fft": 128, "hop_length": 64, "n_mels": 12}
    return {
        "ssl": {**base, "frontend": "ssl", "frontend_conf": {
            "model_name_or_path": str(root / "wav2vec2"), "kind": "wav2vec2"}},
        "wav2vec2_hf": {**base, "frontend": "none", "normalize": "none",
                        "encoder": "wav2vec2_hf", "encoder_conf": {
                            "model_name_or_path": str(root / "wav2vec2"), "output_size": 16}},
        "hubert_hf": {**base, "frontend": "none", "normalize": "none", "encoder": "hubert_hf",
                      "encoder_conf": {"model_name_or_path": str(root / "hubert"),
                                       "output_size": 16}},
        "whisper_hf": {**base, "frontend_conf": mel, "encoder": "whisper_hf",
                       "encoder_conf": {"model_name_or_path": str(root / "whisper"),
                                        "output_size": 16}},
        "sinc": {**base, "normalize": "none", "encoder_conf": lin,
                 "frontend_conf": {"type": "sliding_window", "win_length": 400,
                                   "hop_length": 160},
                 "preencoder": "sinc", "preencoder_conf": {"out_channels": 16,
                                                           "sinc_channels": 8},
                 "postencoder": "length_adaptor", "postencoder_conf": {"n_layers": 1}},
        "bert_post": {**base, "frontend_conf": mel, "postencoder": "hugging_face_transformers",
                      "postencoder_conf": {"model_name_or_path": str(root / "bert"),
                                           "lang_token_id": 7, "length_adaptor_n_layers": 1}},
        "fused": {**base, "frontend_conf": {"fused": [[128, 64, 12], [256, 128, 20]],
                                            "proj_dim": 8}},
        "hf_decoder": {**base, "token_list": None, "token_type": "hugging_face",
                       "bpemodel": str(root / "llm"), "frontend_conf": mel,
                       "decoder": "hugging_face",
                       "decoder_conf": {"model_name_or_path": str(root / "llm"),
                                        "prefix": "ab", "postfix": "c", "enc_frames_max": 64}},
    }


def _text(kind):
    args = list(_batch(1))
    if kind == "hf_decoder":  # ids of the LLM vocabulary
        args[2] = np.array([[20, 21, 22, 23], [24, 25, -1, -1]], np.int32)
    return args


def jax_variables(jmodel, config):
    """Seeded variables (no flax init compile) with every pretrained part
    injected by JAX's own loaders, as its init_model_variables does."""
    variables = seeded_variables(jmodel, *(jnp.asarray(a) for a in _text("x")), seed=5)
    params = dict(variables["params"])
    if config.get("frontend") == "ssl":
        fc = config["frontend_conf"]
        params["ssl_frontend"] = jssl.load_pretrained_encoder(fc["model_name_or_path"],
                                                              fc["kind"])[1]
    if config.get("encoder", "").endswith("_hf"):
        name = config["encoder_conf"]["model_name_or_path"]
        params["encoder"] = {**params["encoder"], "ssl": jssl.load_pretrained_encoder(
            name, config["encoder"][: -len("_hf")])[1]}
    if config.get("postencoder") == "hugging_face_transformers":
        params["postencoder"] = {**params["postencoder"],
                                 **jhe.load_hf_postencoder_params(jmodel.cfg.postencoder[1])}
    if config.get("decoder") == "hugging_face":
        from transformers import AutoModelForCausalLM

        hf = AutoModelForCausalLM.from_pretrained(config["decoder_conf"]["model_name_or_path"],
                                                  torch_dtype=torch.float32)
        params["decoder"] = {**params["decoder"], "llm": jllama.convert_hf_state_dict(
            hf.state_dict(), jmodel.cfg.hf_decoder.llm)}
    return {**variables, "params": params}


@functools.lru_cache(maxsize=None)
def _models(kind, root):
    config = {**jasr.ASRTask.get_default_config(), **configs(root)[kind]}
    jmodel = jasr.build_model(config)
    variables = jax_variables(jmodel, config)
    tmodel = tasr.build_model(config, "cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return config, jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("kind", ["sinc", "bert_post", "fused", "hf_decoder"])
def test_loss_and_gradients_match_jax(hf_dirs, kind):
    """Eval mode (running statistics, no dropout): the stats at rtol 2e-4,
    every gradient at 1e-4 of its largest value plus 1e-6 of the model's
    largest; the configs of both packages agree field for field."""
    config, jmodel, variables, tmodel = _models(kind, hf_dirs)
    if kind == "hf_decoder":
        assert tmodel.cfg.hf_decoder.prefix_ids == jmodel.cfg.hf_decoder.prefix_ids
        assert tmodel.cfg.hf_decoder.postfix_ids == jmodel.cfg.hf_decoder.postfix_ids
        assert tmodel.cfg.hf_decoder.prefix_ids and tmodel.cfg.hf_decoder.postfix_ids
    args = _text(kind)

    def j_loss(params):
        loss, stats, _ = jmodel.apply({**variables, "params": params},
                                      *(jnp.asarray(a) for a in args), deterministic=True)
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    tmodel.zero_grad(set_to_none=True)
    loss, stats, _ = tmodel(*_torch(args))
    loss.backward()
    assert stats.keys() == j_stats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=2e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-6 * max(float(r.abs().max()) for r in want.values())
    for name, g in got.items():
        ref = want[name].numpy()
        g = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4 * np.abs(ref).max() + floor,
                                   err_msg=name)
    tmodel.zero_grad(set_to_none=True)


def test_hf_decoder_beam10_nbest_matches_jax(hf_dirs):
    _, jmodel, variables, tmodel = _models("hf_decoder", hf_dirs)
    vocab, sos = tmodel.cfg.vocab_size, tmodel.cfg.sos_id
    speech = (np.random.default_rng(11).standard_normal(3000) * 0.5).astype(np.float32)
    padded = np.zeros((1, 3200), np.float32)
    padded[0, :3000] = speech
    enc, enc_lens = jit(functools.partial(jmodel.apply, method=jmodel.encode))(
        variables, jnp.asarray(padded), jnp.asarray([3000], jnp.int32))
    j_hyps = JBeamSearch(jmodel, variables, vocab_size=vocab, sos=sos, eos=sos, beam_size=10,
                         ctc_weight=0.3)(enc, enc_lens, maxlenratio=-5.0, nbest=10)
    out = Speech2Text.from_model(tmodel, ctc_weight=0.3, beam_size=10, nbest=10,
                                 maxlenratio=-5.0)(speech)
    assert len(out) == len(j_hyps) == 10
    assert [h.yseq for _, h in out] == [h.yseq for h in j_hyps]
    np.testing.assert_allclose([h.score for _, h in out], [h.score for h in j_hyps], rtol=1e-4)


def _landed(kind, model, config):
    """(port tensor, the JAX loader's tensor) of every pretrained weight."""
    pairs = []
    if kind == "ssl":
        fc = config["frontend_conf"]
        want = params_from_jax({"params": _np(jssl.load_pretrained_encoder(
            fc["model_name_or_path"], fc["kind"])[1])})
        pairs = [(model.ssl_frontend.state_dict()[k], v) for k, v in want.items()]
    elif kind.endswith("_hf"):
        want = params_from_jax({"params": _np(jssl.load_pretrained_encoder(
            config["encoder_conf"]["model_name_or_path"], kind[: -len("_hf")])[1])})
        pairs = [(model.encoder.ssl.state_dict()[k], v) for k, v in want.items()]
    elif kind == "bert_post":
        from transformers import AutoConfig

        d = config["postencoder_conf"]["model_name_or_path"]
        jcfg = jhe.HFPostEncoderConfig(
            body=jhe.BertBodyConfig.from_hf_config(AutoConfig.from_pretrained(d)),
            lang_token_id=7, model_name_or_path=d)
        want = params_from_jax({"params": _np(jhe.load_hf_postencoder_params(jcfg))})
        pairs = [(model.postencoder.state_dict()[k], v) for k, v in want.items()]
    elif kind == "hf_decoder":
        from transformers import AutoConfig, AutoModelForCausalLM

        d = config["decoder_conf"]["model_name_or_path"]
        jcfg = jllama.LlamaConfig.from_hf_config(AutoConfig.from_pretrained(d))
        sd = AutoModelForCausalLM.from_pretrained(d, torch_dtype=torch.float32).state_dict()
        want = params_from_jax({"params": _np(jllama.convert_hf_state_dict(sd, jcfg))})
        pairs = [(model.decoder.llm.state_dict()[k], v) for k, v in want.items()]
    return pairs


@pytest.mark.parametrize("kind", ["ssl", "wav2vec2_hf", "hubert_hf", "whisper_hf", "sinc",
                                  "bert_post", "fused", "hf_decoder"])
def test_yaml_builds_loads_trains_and_decodes(hf_dirs, tmp_path, kind):
    config = configs(hf_dirs)[kind]
    dump_yaml({**config, "optim": "adamw", "optim_conf": {"lr": 1e-3}}, tmp_path / "c.yaml")
    model, full = tasr.ASRTask.build_model_from_file(tmp_path / "c.yaml", device="cpu")
    pairs = _landed(kind, model, full)
    assert bool(pairs) == (kind not in ("sinc", "fused"))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if kind == "ssl":
        speech, lens = _torch(_batch())[:2]
        feats = model.collect_feats(speech, lens)
        assert feats["feats"].shape[-1] == TINY_W2V["hidden_size"]
        with torch.no_grad():
            want = model.ssl_frontend(speech, lens)[0]
        torch.testing.assert_close(feats["feats"], want, rtol=0, atol=0)
    state = ttrainer.init_train_state(model, toptim.build_optimizer("adamw", {"lr": 1e-3}))
    stats, _ = ttrainer.make_fused_train_step(model, state, torch.Generator().manual_seed(0))(
        dict(zip(("speech", "speech_lengths", "text", "text_lengths"), _torch(_text(kind)))))
    assert np.isfinite(float(stats["loss"])) and state.step == 1
    out = Speech2Text.from_model(model.eval(), beam_size=2, maxlenratio=-3.0)(
        (np.random.default_rng(3).standard_normal(3000) * 0.3).astype(np.float32))
    assert out and all(0 <= i < model.cfg.vocab_size for i in out[0][0])


@pytest.mark.parametrize("bad", [{"encoder": "avhubert"}, {"frontend_conf": {"use_wpe": True}},
                                 {"frontend_conf": {"use_beamformer": True, "ref_channel": 1}}])
def test_missing_choices_name_their_roadmap_item(bad):
    """Once refused with ROADMAP item 10d, each choice now builds: the
    audio-only AV-HuBERT encoder, WPE alone (no mask estimator) and the
    beamformer's BiLSTM mask estimator at its reference channel."""
    from llm_guided_asr_tpu_torch.models.avhubert import AVHubertEncoder

    config = {**tasr.ASRTask.get_default_config(), "token_list": TOKENS, **bad}
    model = tasr.build_model(config, "cpu")
    if "encoder" in bad:
        assert isinstance(model.encoder, AVHubertEncoder) and model.encoder.cfg.audio_only
        return
    fe = model.mc_frontend
    assert fe.cfg.use_wpe == bad["frontend_conf"].get("use_wpe", False)
    assert hasattr(fe, "OptimizedLSTMCell_1") == fe.cfg.use_beamformer
    assert fe.cfg.ref_channel == bad["frontend_conf"].get("ref_channel", 0)


@pytest.mark.parametrize("model", ["transducer", "guided"])
@pytest.mark.parametrize("frontend", [{"fused": ((256, 64, 20),)}, {"type": "sliding_window"}])
def test_other_models_refuse_the_ctc_attention_frontends(model, frontend):
    """The fused and sliding-window frontends are the CTC/attention model's
    alone: the transducer and the guided model refuse them (the JAX
    package would compute log-mel features instead)."""
    from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRConfig, LLMGuidedASRModel
    from llm_guided_asr_tpu_torch.models.transducer import TransducerModel, TransducerModelConfig
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

    fe = FrontendConfig(**frontend)
    with pytest.raises(ValueError, match="read by the CTC/attention model only"):
        if model == "transducer":
            TransducerModel(TransducerModelConfig(vocab_size=10, frontend=fe), device="cpu")
        else:
            LLMGuidedASRModel(LLMGuidedASRConfig(vocab_size=10, llm=None, prompt=None,
                                                 frontend=fe), device="cpu")
