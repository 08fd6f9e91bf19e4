"""Port vs JAX, the modules that read local Hugging Face directories, from
the same tiny random checkpoints (written by ``transformers``'
``save_pretrained``; nothing is downloaded):

- models/hf_checkpoint.py reads ``model.safetensors`` and
  ``pytorch_model.bin`` to the same tensors as ``transformers`` holds;
- the wav2vec2 trunk, base-style (group norm, post-norm) and large-style
  (layer norm, pre-norm), and HuBERT: the port's converter from the
  directory equals the JAX converter's tree (params_from_jax), for both
  weight-norm layouts of the positional conv; outputs and lengths on a
  batch with a padded row;
- the Whisper encoder (and its position limit), the sinc pre-encoder (eval
  and training mode), the length adaptor, the BERT post-encoder (with and
  without a language token and the adaptor; RoBERTa's embeddings), the
  fused frontend and the ``hugging_face`` decoder's logits (full and
  ``only_last``).

Forward tolerance 1e-4 * max|ref| + 1e-5, float32.
"""

import flax.linen as jax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import hf_decoder as jhd
from llm_guided_asr_tpu.models import hf_encoder as jhe
from llm_guided_asr_tpu.models import preencoder as jpre
from llm_guided_asr_tpu.models import ssl_encoders as jssl
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.ops import frontend as jfe
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import hf_decoder as thd
from llm_guided_asr_tpu_torch.models import hf_encoder as the
from llm_guided_asr_tpu_torch.models import preencoder as tpre
from llm_guided_asr_tpu_torch.models import ssl_encoders as tssl
from llm_guided_asr_tpu_torch.models.hf_checkpoint import load_hf_state_dict, read_hf_config
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
from llm_guided_asr_tpu_torch.ops.frontend import FusedFrontend
from test_torch_branchformer import _load, _np
from test_torch_train import jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

TINY_W2V = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=48, conv_dim=[16, 16], conv_kernel=[10, 3], conv_stride=[5, 2],
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
W2V_KINDS = {  # name -> (transformers class names, feat_extract_norm, stable, conv_bias)
    "wav2vec2_base": ("Wav2Vec2", "group", False, False),
    "wav2vec2_large": ("Wav2Vec2", "layer", True, True),
    "hubert": ("Hubert", "group", False, False),
}


def close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()) + 1e-5, err_msg=what)


def legacy_weight_norm(sd):
    """A state dict with the parametrize layout renamed to the legacy one."""
    out = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        out[k.replace("parametrizations.weight.original1", "weight_v")] = v
    return out


def write_w2v_dir(root, name):
    import transformers

    cls, norm, stable, bias = W2V_KINDS[name]
    torch.manual_seed(0)
    hf_cfg = getattr(transformers, f"{cls}Config")(
        **TINY_W2V, feat_extract_norm=norm, do_stable_layer_norm=stable, conv_bias=bias)
    model = getattr(transformers, f"{cls}Model")(hf_cfg).eval()
    d = root / name
    model.save_pretrained(d)
    return d, hf_cfg, model


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {name: write_w2v_dir(root, name) for name in W2V_KINDS}


def test_checkpoint_reader_matches_transformers(dirs, tmp_path):
    """safetensors and pytorch_model.bin (legacy weight-norm names) read to
    the tensors the model holds; config.json to a plain dict."""
    d, hf_cfg, model = dirs["hubert"]
    want = model.state_dict()
    got = load_hf_state_dict(d)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    torch.save(legacy_weight_norm(want), tmp_path / "pytorch_model.bin")
    got_bin = load_hf_state_dict(tmp_path)
    assert "encoder.pos_conv_embed.conv.weight_g" in got_bin
    assert read_hf_config(d)["hidden_size"] == hf_cfg.hidden_size


@pytest.mark.parametrize("name", list(W2V_KINDS))
@pytest.mark.parametrize("layout", ["parametrize", "legacy"])
def test_w2v_converter_matches_jax(dirs, name, layout):
    d, hf_cfg, model = dirs[name]
    sd = model.state_dict()
    if layout == "legacy":
        sd = legacy_weight_norm(sd)
    jcfg = jssl.W2VConfig.from_hf_config(hf_cfg)
    want = params_from_jax({"params": jssl.convert_hf_wav2vec2_state_dict(sd, jcfg)})
    tcfg = tssl.W2VConfig.from_hf_config(read_hf_config(d))
    assert tcfg == tssl.W2VConfig(**vars(jcfg))
    got = tssl.convert_hf_wav2vec2_state_dict(sd, tcfg)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k], k)


@pytest.mark.parametrize("name", list(W2V_KINDS))
def test_w2v_encoder_matches_jax(dirs, name):
    """Outputs and lengths on a padded batch (the group norm takes its
    statistics over the padded row's pads, in both)."""
    d, hf_cfg, _ = dirs[name]
    jcfg, jparams = jssl.load_pretrained_encoder(str(d), "hubert" if name == "hubert"
                                                 else "wav2vec2")
    wav = np.random.default_rng(0).standard_normal((2, 2000)).astype(np.float32)
    lens = np.array([2000, 1333], np.int32)
    want, want_lens = jit(jssl.Wav2Vec2Encoder(jcfg).apply)(
        {"params": jparams}, jnp.asarray(wav), jnp.asarray(lens))
    tcfg, sd = tssl.load_pretrained_encoder(d, "hubert" if name == "hubert" else "wav2vec2")
    enc = tssl.Wav2Vec2Encoder(tcfg)
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, got_lens = enc(torch.from_numpy(wav), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got.numpy(), want)


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    from transformers import WhisperConfig, WhisperModel

    torch.manual_seed(0)
    hf_cfg = WhisperConfig(d_model=32, encoder_layers=2, encoder_attention_heads=2,
                           encoder_ffn_dim=48, num_mel_bins=12, max_source_positions=20,
                           decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=48)
    d = tmp_path_factory.mktemp("whisper")
    WhisperModel(hf_cfg).save_pretrained(d)
    return d


def test_whisper_encoder_matches_jax(whisper_dir):
    jcfg, jparams = jssl.load_pretrained_encoder(str(whisper_dir), "whisper")
    tcfg, sd = tssl.load_pretrained_encoder(whisper_dir, "whisper")
    want_sd = params_from_jax({"params": jparams})
    assert sd.keys() == want_sd.keys()
    feats = np.random.default_rng(1).standard_normal((2, 33, 12)).astype(np.float32)
    lens = np.array([33, 21], np.int32)
    want, want_lens = jit(jssl.WhisperEncoder(jcfg).apply)(
        {"params": jparams}, jnp.asarray(feats), jnp.asarray(lens))
    enc = tssl.WhisperEncoder(tcfg)
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, got_lens = enc(torch.from_numpy(feats), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got.numpy(), want)
    # 42 mel frames -> 21 half-rate frames > 20 positions: both raise
    long = np.zeros((1, 42, 12), np.float32)
    with pytest.raises(Exception):
        jssl.WhisperEncoder(jcfg).apply({"params": jparams}, jnp.asarray(long),
                                        jnp.asarray([42]))
    with pytest.raises(ValueError, match="max_source_positions"):
        enc(torch.from_numpy(long), torch.tensor([42]))


def _no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every Dropout the identity (the sinc blocks' first
    dropout is 0.1 whatever the config says)."""
    if context.method_name == "__call__" and isinstance(context.module, jax_nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.mark.parametrize("train", [False, True])
def test_sinc_preencoder_matches_jax(train, monkeypatch):
    """Raw frames of the sliding window through the sinc pre-encoder: the
    running statistics (eval) or the batch's (training, which also moves
    the running ones), output and gradients; dropout off in both."""
    monkeypatch.setattr(tpre, "dropout", lambda x, rate, rng: x)
    cfg = dict(out_channels=16, sinc_channels=8, dropout_rate=0.0)
    wav = np.random.default_rng(2).standard_normal((2, 1300)).astype(np.float32) * 0.1
    lens = np.array([1300, 1000], np.int32)
    jframes, jlens = jpre.sliding_window(jnp.asarray(wav), jnp.asarray(lens), 400, 160)
    frames, flens = tpre.sliding_window(torch.from_numpy(wav), torch.from_numpy(lens).long(),
                                        400, 160)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    np.testing.assert_array_equal(flens.numpy(), np.asarray(jlens))
    jmod = jpre.LightweightSincConvs(jpre.SincPreencoderConfig(**cfg))
    variables = seeded_variables(jmod, jframes, seed=3)
    variables["params"]["filters"]["f"] = jpre.mel_filter_bank(8, 16000.0)
    r = np.random.default_rng(4).standard_normal((2, frames.shape[1], 16)).astype(np.float32)

    def loss(params):
        with jax_nn.intercept_methods(_no_dropout):
            out, upd = jmod.apply({**variables, "params": params}, jframes, not train,
                                  mutable=["batch_stats"])
        return jnp.sum(out * r), (out, upd)

    (_, (want, upd)), jgrads = jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    tmod = _load(tpre.LightweightSincConvs(tpre.SincPreencoderConfig(**cfg)), variables)
    tmod.train(train)
    got = tmod(frames)
    close(got.detach().numpy(), want)
    (got * torch.from_numpy(r)).sum().backward()
    want_g = params_from_jax({"params": _np(jgrads)})
    for n, p in tmod.named_parameters():
        close(p.grad.numpy(), want_g[n].numpy(), n)
    if train:
        stats = params_from_jax({"batch_stats": _np(upd["batch_stats"])})
        for n, b in tmod.named_buffers():
            close(b.numpy(), stats[n].numpy(), n)


@pytest.mark.parametrize("input_layer", [None, "linear"])
def test_length_adaptor_matches_jax(input_layer):
    cfg = dict(n_layers=2, input_layer=input_layer, output_size=10, dropout_rate=0.0)
    x = np.random.default_rng(5).standard_normal((2, 11, 6)).astype(np.float32)
    lens = np.array([11, 5], np.int32)
    jmod = jpre.LengthAdaptorPostEncoder(jpre.LengthAdaptorConfig(**cfg))
    variables = seeded_variables(jmod, jnp.asarray(x), jnp.asarray(lens), seed=6)
    want, want_lens = jmod.apply(variables, jnp.asarray(x), jnp.asarray(lens))
    tmod = _load(tpre.LengthAdaptorPostEncoder(tpre.LengthAdaptorConfig(**cfg), 6), variables)
    with torch.no_grad():
        got, got_lens = tmod.eval()(torch.from_numpy(x), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got.numpy(), want)


@pytest.fixture(scope="module")
def bert_dirs(tmp_path_factory):
    from transformers import BertConfig, BertModel, RobertaConfig, RobertaModel

    out = {}
    for name, cfg_cls, model_cls in (("bert", BertConfig, BertModel),
                                     ("roberta", RobertaConfig, RobertaModel)):
        torch.manual_seed(0)
        cfg = cfg_cls(vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=32, max_position_embeddings=40, pad_token_id=1)
        d = tmp_path_factory.mktemp(name)
        model_cls(cfg).save_pretrained(d)
        out[name] = d
    return out


@pytest.mark.parametrize("lang,adaptor", [(-1, 0), (7, 1)])
def test_bert_postencoder_matches_jax(bert_dirs, lang, adaptor):
    """The post-encoder over a ragged batch: the body from the directory,
    the adaptor and linear_in from the test's seed, the language token's
    word-embedding row; valid frames only (the body does not zero pads)."""
    d = str(bert_dirs["bert"])
    from transformers import AutoConfig

    jbody = jhe.BertBodyConfig.from_hf_config(AutoConfig.from_pretrained(d))
    jcfg = jhe.HFPostEncoderConfig(body=jbody, length_adaptor_n_layers=adaptor,
                                   lang_token_id=lang, model_name_or_path=d)
    x = np.random.default_rng(7).standard_normal((2, 9, 12)).astype(np.float32)
    lens = np.array([9, 6], np.int32)
    jmod = jhe.HFTransformersPostEncoder(jcfg)
    variables = seeded_variables(jmod, jnp.asarray(x), jnp.asarray(lens), seed=8)
    variables = {"params": {**variables["params"], **jhe.load_hf_postencoder_params(jcfg)}}
    want, want_lens = jmod.apply(variables, jnp.asarray(x), jnp.asarray(lens))
    tcfg = the.HFPostEncoderConfig(body=the.read_bert_config(d), length_adaptor_n_layers=adaptor,
                                   lang_token_id=lang, model_name_or_path=d)
    assert tcfg.body == the.BertBodyConfig(**vars(jbody))
    tmod = the.HFTransformersPostEncoder(tcfg, 12).eval()
    pre = the.load_hf_postencoder_params(tcfg)
    want_pre = params_from_jax({"params": _np(jhe.load_hf_postencoder_params(jcfg))})
    assert pre.keys() == want_pre.keys()
    for k in pre:
        close(pre[k], want_pre[k], k)
    _load(tmod, variables)
    with torch.no_grad():
        got, got_lens = tmod(torch.from_numpy(x), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    for b in range(2):
        n = int(want_lens[b])
        close(got[b, :n].numpy(), np.asarray(want)[b, :n])
    with pytest.raises(ValueError, match="length adaptor"):
        the.HFTransformersPostEncoder(
            the.HFPostEncoderConfig(body=tcfg.body, length_adaptor_n_layers=4), 12).eval()(
            torch.zeros(1, 9, 12), torch.tensor([9]))


def test_roberta_embeddings_match_jax(bert_dirs):
    """RoBERTa's positions start at pad_token_id + 1 (the embeddings are
    the token-id encoder's; the post-encoder skips them)."""
    from transformers import AutoConfig, AutoModel

    d = bert_dirs["roberta"]
    jcfg = jhe.BertBodyConfig.from_hf_config(AutoConfig.from_pretrained(d))
    jparams = jhe.convert_hf_bert_weights(AutoModel.from_pretrained(d).state_dict(), jcfg)
    ids = np.array([[5, 9, 3, 11]], np.int32)
    want = jhe.BertEmbeddings(jcfg).apply({"params": jparams["embeddings"]}, jnp.asarray(ids))
    tcfg = the.read_bert_config(d)
    sd = the.convert_hf_bert_weights(load_hf_state_dict(d), tcfg)
    emb = the.BertEmbeddings(tcfg).eval()
    emb.load_state_dict({k[len("embeddings."):]: v for k, v in sd.items()
                         if k.startswith("embeddings.")})
    with torch.no_grad():
        close(emb(torch.from_numpy(ids).long()).numpy(), want)
    with pytest.raises(ValueError, match="bert/roberta"):
        the.BertBodyConfig.from_hf_config({"model_type": "gpt2"})


def test_fused_frontend_matches_jax():
    fused = ((256, 64, 20), (512, 128, 16))
    wav = np.random.default_rng(9).standard_normal((2, 3000)).astype(np.float32)
    lens = np.array([3000, 2100], np.int32)
    jmod = jfe.FusedFrontend(frontends=fused, proj_dim=6)
    variables = seeded_variables(jmod, jnp.asarray(wav), jnp.asarray(lens), seed=10)
    want, want_lens = jit(jmod.apply)(variables, jnp.asarray(wav), jnp.asarray(lens))
    tmod = _load(FusedFrontend(fused, proj_dim=6), variables)
    with torch.no_grad():
        got, got_lens = tmod(torch.from_numpy(wav), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    close(got.numpy(), want)


@pytest.fixture(scope="module")
def llm_dir(tmp_path_factory):
    from llm_guided_asr_tpu.utils.testing import make_tiny_llm_dir

    return make_tiny_llm_dir(tmp_path_factory.mktemp("llm"))


def test_hf_decoder_matches_jax(llm_dir):
    """Packed [prefix, enc, postfix, ys] logits with a padded encoder row
    (mid-row pads) and ragged ys, full and only_last."""
    import json

    hf = json.loads((llm_dir / "config.json").read_text())
    from transformers import AutoConfig

    jllm = JLlamaConfig.from_hf_config(AutoConfig.from_pretrained(llm_dir))
    jdec = jhd.HFCausalDecoder(jhd.HFCausalDecoderConfig(llm=jllm, prefix_ids=(1, 5),
                                                         postfix_ids=(6,), enc_frames_max=5))
    rng = np.random.default_rng(11)
    mem = rng.standard_normal((2, 6, 8)).astype(np.float32)
    mlens = np.array([6, 3], np.int32)
    ys = np.array([[2, 3, 4], [3, 4, 0]], np.int32)
    ylens = np.array([3, 2], np.int32)
    args = tuple(jnp.asarray(a) for a in (mem, mlens, ys, ylens))
    variables = seeded_variables(jdec, *args, seed=12)
    want = jit(jdec.apply)(variables, *args)
    want_last = jit(lambda v, *a: jdec.apply(v, *a, only_last=True))(variables, *args)
    tcfg = thd.HFCausalDecoderConfig(llm=LlamaConfig.from_hf_config(hf), prefix_ids=(1, 5),
                                     postfix_ids=(6,), enc_frames_max=5)
    assert tcfg.llm == LlamaConfig(**vars(jllm))
    tdec = _load(thd.HFCausalDecoder(tcfg, 8, device="cpu"), variables)
    targs = (torch.from_numpy(mem), torch.from_numpy(mlens).long(), torch.from_numpy(ys).long(),
             torch.from_numpy(ylens).long())
    with torch.no_grad():
        got = tdec(*targs)
        got_last = tdec(*targs, only_last=True)
    for b in range(2):
        close(got[b, : ylens[b]].numpy(), np.asarray(want)[b, : ylens[b]])
    close(got_last.numpy(), want_last)
