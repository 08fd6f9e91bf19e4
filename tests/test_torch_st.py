"""LLM-guided speech translation, port against the JAX package: one tiny ST
model over the byte-level fixture LLM (tests/parity/tiny_llm_bytelevel)
in both packages with the same weights (the JAX variables drawn from a
numpy seed, the LLM's from the fixture's safetensors, carried over by
convert.py).  The loss and every stats term with and without the extra
ASR decoder and at mtlalpha 0, 0.5 and 1, the gradients, the guided
decoder's logits, Speech2Translation's 5-best against the JAX beam search,
and a JAX-written config.yaml and .msgpack decoded by the port's
st_inference CLI to JAX's hypothesis (its text through the port's
tokenizer, which tests/test_torch_llm_tokenizers.py holds to
AutoTokenizer on this fixture)."""

import dataclasses
import json
import types
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import llm_guided_st as jst
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.llm.ingest import stream_llm_params
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
from llm_guided_asr_tpu.models.transformer_decoder import TransformerDecoderConfig as JDecCfg
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.tasks.st import ST_DEFAULTS as J_ST_DEFAULTS
from llm_guided_asr_tpu.train.checkpoint import save_pytree
from llm_guided_asr_tpu.utils.config import dump_yaml as j_dump_yaml
from llm_guided_asr_tpu_torch.bin import st_inference
from llm_guided_asr_tpu_torch.bin.st_inference import Speech2Translation
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text, write_wav
from llm_guided_asr_tpu_torch.models.llm_guided import resolve_llm_spec
from llm_guided_asr_tpu_torch.tasks import st as tst
from llm_guided_asr_tpu_torch.text.tokenizers import HuggingFaceTokenizer
from test_torch_transducer import seeded_variables

LLM_DIR = Path(__file__).resolve().parent / "parity" / "tiny_llm_bytelevel"
ENCODER = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=1,
               macaron_style=False, cnn_module_kernel=7)
DECODER = dict(attention_heads=2, linear_units=64, num_blocks=1)
EXTRA = dict(attention_heads=2, linear_units=64, num_blocks=1)
FRONTEND = dict(n_fft=256, hop_length=128, n_mels=23)
CONFIG = {
    "model": "llm_guided_st", "token_type": "hugging_face", "bpemodel": str(LLM_DIR),
    "llm_conf": {"model_name_or_path": str(LLM_DIR), "template_prompt": 'fix ((HYP)) -> "',
                 "dtype": "float32"},
    "frontend_conf": FRONTEND, "normalize": "utterance_mvn", "encoder_conf": ENCODER,
    "decoder_conf": DECODER, "extra_asr_decoder_conf": EXTRA,
    "model_conf": {"asr_weight": 0.3, "mtlalpha": 0.5, "lsm_weight": 0.1},
}
# (extra_asr_decoder, mtlalpha): with and without the extra decoder, and
# mtlalpha 0 (no CTC term), 0.5 and 1 (no attention term)
VARIANTS = [(True, 0.5), (False, 0.5), (True, 0.0), (True, 1.0)]
EOS_LIFT = 1.0


def _jax_model(spec, extra=True, mtlalpha=0.5):
    hf = json.loads((LLM_DIR / "config.json").read_text())
    llm = JLlamaConfig.from_hf_config(types.SimpleNamespace(**hf))
    v = llm.vocab_size
    cfg = jst.LLMGuidedSTConfig(
        vocab_size=v, src_vocab_size=v, llm=llm,
        prompt=JPromptTemplate(**dataclasses.asdict(spec["template"])),
        frontend=JFrontendConfig(**FRONTEND), normalize="utterance_mvn",
        encoder=JConformerConfig(**ENCODER), decoder=JDecCfg(**DECODER),
        extra_asr_decoder=JDecCfg(**EXTRA) if extra else None, mtlalpha=mtlalpha,
        lsm_weight=0.1)
    return jst.LLMGuidedSTModel(cfg)


def _batch():
    rng = np.random.default_rng(0)
    return {"speech": (rng.standard_normal((2, 6000)) * 0.1).astype(np.float32),
            "speech_lengths": np.array([6000, 4100], np.int32),
            "text": np.array([[20, 33, 41, -1], [55, 66, -1, -1]], np.int32),
            "text_lengths": np.array([3, 2], np.int32),
            "src_text": np.array([[7, 8, 9], [10, 11, -1]], np.int32),
            "src_text_lengths": np.array([3, 2], np.int32)}


def _torch(batch, names):
    return [torch.from_numpy(batch[k]) if batch[k].dtype == np.float32
            else torch.from_numpy(batch[k]).long() for k in names]


@pytest.fixture(scope="module")
def models():
    spec = resolve_llm_spec(CONFIG["llm_conf"])
    jmodel = _jax_model(spec)
    batch = _batch()
    args = [jnp.asarray(batch[k]) for k in tst.ST_BATCH_ARGS]
    variables = seeded_variables(jmodel, *args, seed=0)
    llm = stream_llm_params(LLM_DIR, jmodel.cfg.llm, dtype=jnp.float32)
    # a lift of eos's logit, so that hypotheses end on their own within
    # the 48-token cap
    out = variables["params"]["output_layer"]
    out = {**out, "bias": out["bias"].at[jmodel.cfg.eos_id].add(EOS_LIFT)}
    variables = {**variables, "params": {**variables["params"], "llm": llm, "output_layer": out}}
    tmodel = tst.build_st_model({**CONFIG, "device": "cpu"}, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    return spec, jmodel, variables, tmodel.eval(), batch


@pytest.fixture(scope="module")
def jax_results(models):
    """Every variant's loss and stats, the teacher-forced guided decoder's
    logits, and the gradients of the (extra, 0.5) loss, from one compiled
    function."""
    spec, _, variables, _, batch = models
    args = [jnp.asarray(batch[k]) for k in tst.ST_BATCH_ARGS]
    jms = {v: _jax_model(spec, *v) for v in VARIANTS}
    shared = {}

    def once(next_fun, f_args, f_kwargs, context):
        """The variants share the first one's encoder output and guided
        decoder logits (same weights, same batch): traced once, not four
        times; the rest of each variant's __call__ runs as it is."""
        if context.method_name not in ("encode", "decoder_logits"):
            return next_fun(*f_args, **f_kwargs)
        if context.method_name not in shared:
            shared[context.method_name] = next_fun(*f_args, **f_kwargs)
        return shared[context.method_name]

    def run(params):
        shared.clear()
        with nn.intercept_methods(once):
            out = {v: m.apply({**variables, "params": params}, *args, deterministic=True)[:2]
                   for v, m in jms.items()}
        return out[(True, 0.5)][0], (out, shared["decoder_logits"])

    (_, out), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(variables["params"])
    return jax.tree_util.tree_map(np.asarray, (*out, grads))


@pytest.mark.parametrize("extra,mtlalpha", VARIANTS)
def test_loss_and_stats_match_jax(models, jax_results, extra, mtlalpha):
    _, _, _, tmodel, batch = models
    cfg = dataclasses.replace(tmodel.cfg, mtlalpha=mtlalpha,
                              extra_asr_decoder=tmodel.cfg.extra_asr_decoder if extra else None)
    saved = tmodel.cfg
    tmodel.cfg = cfg
    try:
        with torch.no_grad():
            loss, stats, weight = tmodel(*_torch(batch, tst.ST_BATCH_ARGS))
    finally:
        tmodel.cfg = saved
    j_loss, j_stats = jax_results[0][(extra, mtlalpha)]
    assert sorted(stats) == sorted(j_stats)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=2e-4)
    for k in j_stats:
        np.testing.assert_allclose(float(stats[k]), float(j_stats[k]), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    want = 0.7 * float(stats["loss_st_att"]) + 0.3 * float(stats["loss_asr"])
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    assert float(weight) == 2.0


def test_gradients_match_jax(models, jax_results):
    """Every trainable tensor's gradient within 1e-4 of the largest
    reference gradient; the frozen LLM gets none in either package."""
    _, _, _, tmodel, batch = models
    grads = params_from_jax({"params": jax_results[2]})
    tmodel.zero_grad(set_to_none=True)
    loss, _, _ = tmodel(*_torch(batch, tst.ST_BATCH_ARGS))
    loss.backward()
    # a tensor whose gradient is 0 in exact arithmetic (the attention key
    # biases) is held to the largest gradient's float32 noise
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in grads.values())
    checked = 0
    for name, p in tmodel.named_parameters():
        ref = grads[name].numpy()
        if name.startswith("llm."):
            assert p.grad is None and not np.any(ref), name
            continue
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * max(np.abs(ref).max(), floor),
                                   rtol=0, err_msg=name)
        checked += 1
    assert checked > 50 and any(np.abs(g.numpy()).max() > 0 for n, g in grads.items()
                                if n.startswith("extra_asr_decoder."))
    tmodel.zero_grad(set_to_none=True)


def test_logits_match_jax(models, jax_results):
    """The teacher-forced guided decoder on the batch (first pass from the
    source-vocab CTC head into the prompt): every valid position, and the
    last one alone (only_last)."""
    _, jmodel, _, tmodel, batch = models
    speech, slens, text, tlens = _torch(batch, tst.ST_BATCH_ARGS[:4])
    cfg = tmodel.cfg
    from llm_guided_asr_tpu_torch.ops.losses import add_sos_eos

    ys_in, _ = add_sos_eos(text, tlens, cfg.sos_id, cfg.eos_id, cfg.ignore_id)
    with torch.no_grad():
        enc, enc_lens = tmodel.encode(speech, slens)
        full = tmodel.decoder_logits(enc, enc_lens, ys_in, tlens + 1).numpy()
        last = tmodel.decoder_logits(enc, enc_lens, ys_in, tlens + 1, only_last=True).numpy()
    want = jax_results[1]
    for b, n in enumerate(tlens.numpy() + 1):
        np.testing.assert_allclose(full[b, :n], want[b, :n], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(last[b], want[b, n - 1], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_nbest(models):
    """The JAX search at Speech2Translation's defaults (beam 5, ctc_weight
    0, 48-token cap) on a 0.44 s request, from the JAX encoder."""
    _, jmodel, variables, _, _ = models
    wave = (np.random.default_rng(5).standard_normal(7000) * 0.1).astype(np.float32)
    wave = (wave * 32767.0).astype(np.int16).astype(np.float32) / 32768.0  # the wav round trip
    padded = np.zeros((8000,), np.float32)  # to a multiple of speech_pad_multiple (1600)
    padded[:7000] = wave
    enc, lens = jax.jit(lambda s, n: jmodel.apply(variables, s, n, method=jmodel.encode))(
        jnp.asarray(padded[None]), jnp.asarray([7000]))
    cfg = jmodel.cfg
    beam = JBeamSearch(jmodel, variables, vocab_size=cfg.vocab_size, sos=cfg.sos_id,
                       eos=cfg.eos_id, beam_size=5, ctc_weight=0.0)
    return wave, beam(enc, lens, maxlenratio=-48.0, nbest=5)


def test_speech2translation_nbest_matches_jax(models, jax_nbest):
    _, _, _, tmodel, _ = models
    wave, want = jax_nbest
    got = Speech2Translation.from_model(tmodel, nbest=5, device="cpu")(wave)
    assert len(got) == len(want) == 5
    for (ids, hyp), ref in zip(got, want):
        assert hyp.yseq == [int(i) for i in ref.yseq]
        np.testing.assert_allclose(hyp.score, float(ref.score), atol=1e-4, rtol=0)
    assert max(len(h.yseq) for _, h in got) > 20  # ended by eos, within the cap


def test_st_inference_decodes_a_jax_directory(models, jax_nbest, tmp_path):
    """config.yaml and .msgpack (the LLM left out) as the JAX STTask
    writes them, decoded by the port's st_inference CLI: JAX's text."""
    _, _, variables, _, _ = models
    wave, want = jax_nbest
    j_dump_yaml({**J_ST_DEFAULTS, **CONFIG, "output_dir": str(tmp_path)},
                tmp_path / "config.yaml")
    save_pytree(tmp_path / "valid.loss.ave.msgpack", variables, exclude_prefixes=("params/llm",))
    write_wav(tmp_path / "u1.wav", 16000, wave)
    (tmp_path / "wav.scp").write_text(f"u1 {tmp_path / 'u1.wav'}\n")
    st_inference.main(["--train_config", str(tmp_path / "config.yaml"), "--model_file",
                       str(tmp_path / "valid.loss.ave.msgpack"), "--wav_scp",
                       str(tmp_path / "wav.scp"), "--output_dir", str(tmp_path / "dec"),
                       "--device", "cpu"])
    tok = HuggingFaceTokenizer(LLM_DIR)
    special = (models[1].cfg.sos_id, models[1].cfg.eos_id)
    ids = [int(i) for i in want[0].yseq if int(i) not in special]
    tokens = tok.tokenizer.convert_ids_to_tokens(ids)
    dec = tmp_path / "dec" / "1best_recog"
    assert read_2columns_text(dec / "token")["u1"] == " ".join(tokens)
    assert read_2columns_text(dec / "text")["u1"] == tok.tokens2text(tokens)
    np.testing.assert_allclose(float(read_2columns_text(dec / "score")["u1"]),
                               float(want[0].score), rtol=1e-5)
