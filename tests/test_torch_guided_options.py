"""Port vs JAX: the LLM-guided model's options -- biasing words at the
((BIAS)) slot (teacher-forced logits, the loss, cached steps, the beam
search and Speech2Text switching bias between calls), the log_softmax score
mode, and mixed-vocab CTC (first pass and loss).  Weights are drawn from a
numpy seed in the JAX layout and carried across by convert.params_from_jax."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import llm_guided as jlg
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
from llm_guided_asr_tpu.models.transformer_decoder import TransformerDecoderConfig as JDecConfig
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.search.scorers import CachedGuidedScorer as JCachedScorer
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import llm_guided as tlg
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
from llm_guided_asr_tpu_torch.models.llm.prompt import build_ctc_to_llm_map, split_template
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer
from llm_guided_asr_tpu_torch.text.tokenizers import HuggingFaceTokenizer, LLMTokenizer
from test_torch_train import jit

torch.set_num_threads(1)

BPE_DIR = Path(__file__).resolve().parent / "parity" / "tiny_llm_bpe"
V = 54  # the BPE tokenizer's vocabulary
LLM = dict(vocab_size=V, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2)
FRONTEND = dict(n_fft=256, hop_length=128, n_mels=23)
# one block each: the options are about the prompt and the scores, not
# depth, and XLA compiles each JAX call in about half the time of two
ENCODER = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=1,
               macaron_style=True, cnn_module_kernel=7)
DECODER = dict(attention_heads=2, linear_units=64, num_blocks=1)
BIAS_TEMPLATE = 'words: ((BIAS)) fix "((HYP))" -> "'
CTC_TOKENS = ["<blank>", "<unk>", "ab", "c", "a", "b", "<sos/eos>"]
N = 6000


def _template():
    t = split_template(LLMTokenizer.from_pretrained(BPE_DIR), BIAS_TEMPLATE, 51, 52, "<unk>")
    assert t.has_bias_slot
    return t


def _fill(shapes, seed):
    """Init-like values from a numpy seed (dense kernels 1/sqrt(fan-in),
    norm scales near 1, small biases), without compiling the init."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "weight", "var"):
            x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "kernel":
            x = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "embedding":
            x = rng.standard_normal(leaf.shape)
        else:
            x = 0.1 * rng.standard_normal(leaf.shape)
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models(seed=0, **options):
    """(JAX model, its variables, the port's model with the same weights)."""
    template = _template()
    jcfg = jlg.LLMGuidedASRConfig(
        vocab_size=V, llm=JLlamaConfig(**LLM), prompt=JPromptTemplate(**template.__dict__),
        frontend=JFrontendConfig(**FRONTEND), normalize="utterance_mvn",
        encoder=JConformerConfig(**ENCODER), decoder=JDecConfig(**DECODER), ctc_weight=0.3,
        **options)
    jmodel = jlg.LLMGuidedASRModel(jcfg)
    args = (jnp.zeros((1, N)), jnp.asarray([N]), jnp.ones((1, 3), jnp.int32), jnp.asarray([3]))
    extra = {"ctc_text": jnp.ones((1, 2), jnp.int32), "ctc_text_lengths": jnp.asarray([2])} \
        if options.get("ctc_vocab_size") else {}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args, **extra))
    variables = dict(_fill({k: v for k, v in shapes.items() if k != "ctc_map"}, seed))
    if options.get("llm_score_mode") == "log_softmax":  # the head only decode_step reads
        variables["params"] = {**variables["params"], "llm": {
            **variables["params"]["llm"], "lm_head": {"kernel": jnp.asarray(
                np.random.default_rng(seed + 1).standard_normal((32, V)) / np.sqrt(32),
                jnp.float32)}}}
    if options.get("ctc_vocab_size"):
        ids, lens = build_ctc_to_llm_map(CTC_TOKENS, LLMTokenizer.from_pretrained(BPE_DIR),
                                         options.get("ctc_map_width", 8))
        variables["ctc_map"] = {"ids": jnp.asarray(ids), "lens": jnp.asarray(lens)}
    tcfg = tlg.LLMGuidedASRConfig(
        vocab_size=V, llm=LlamaConfig(**LLM), prompt=template,
        frontend=FrontendConfig(**FRONTEND), normalize="utterance_mvn",
        encoder=ConformerConfig(**ENCODER), decoder=TransformerDecoderConfig(**DECODER),
        ctc_weight=0.3, **options)
    tmodel = tlg.LLMGuidedASRModel(tcfg, llm_dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def biased():
    return _models()


def _bias(words_per_row, width=8):
    tok = LLMTokenizer.from_pretrained(BPE_DIR)
    rows = [tok(", ".join(w))["input_ids"] for w in words_per_row]
    ids = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
    return ids, np.array([len(r) for r in rows])


def _enc(b=2, t=20, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, 32)).astype(np.float32), np.array([t, t - 6][:b])


def test_bias_decoder_logits_and_loss_match_jax(biased):
    jmodel, variables, tmodel = biased
    enc, enc_lens = _enc()
    bias, bias_lens = _bias([["abc"], ["cab", "b"]])
    ys = np.array([[1, 11, 12, 13], [1, 13, 0, 0]])
    ys_lens = np.array([4, 2])
    j = jit(lambda *a: jmodel.apply(variables, *a[:4], bias_words=a[4],
                                        bias_words_lengths=a[5], method=jmodel.decoder_logits))
    j_logits = np.asarray(j(*(jnp.asarray(x) for x in (enc, enc_lens, ys, ys_lens, bias,
                                                        bias_lens))))
    T = torch.from_numpy
    with torch.no_grad():
        t_logits = tmodel.decoder_logits(T(enc), T(enc_lens), T(ys), T(ys_lens),
                                         bias_words=T(bias), bias_words_lengths=T(bias_lens))
        plain = tmodel.decoder_logits(T(enc), T(enc_lens), T(ys), T(ys_lens))
    for b, n in enumerate(ys_lens):
        np.testing.assert_allclose(t_logits.numpy()[b, :n], j_logits[b, :n], rtol=1e-3, atol=2e-4)
    assert not np.allclose(t_logits.numpy(), plain.numpy(), atol=1e-3)  # bias conditions the LLM

    rng = np.random.default_rng(6)
    speech = (rng.standard_normal((2, N)) * 0.1).astype(np.float32)
    slens = np.array([N, 4000])
    text, tlens = np.array([[11, 12, 13], [13, -1, -1]]), np.array([3, 1])
    j_loss, j_stats, _ = jit(lambda *a: jmodel.apply(variables, *a[:4], bias_words=a[4],
                                                         bias_words_lengths=a[5]))(
        *(jnp.asarray(x) for x in (speech, slens, text, tlens, bias, bias_lens)))
    with torch.no_grad():
        t_loss, t_stats, _ = tmodel(T(speech), T(slens), T(text), T(tlens),
                                    bias_words=T(bias), bias_words_lengths=T(bias_lens))
    for name in ("loss", "loss_att", "loss_ctc"):
        np.testing.assert_allclose(float(t_stats[name]), float(j_stats[name]), rtol=2e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=2e-4)


def test_bias_cached_steps_match_jax(biased):
    """Cached decoding with bias ids through CachedGuidedScorer (JAX:
    set_bias; the port: per-call ctx and set_bias alike), with a beam
    reordering; the bias changes every step's scores."""
    jmodel, variables, tmodel = biased
    enc, enc_lens = _enc(b=1)
    bias, bias_lens = _bias([["abc", "ab"]])
    K, LMAX = 3, 6
    j_sc = JCachedScorer(jmodel, variables)
    j_sc.set_bias(jnp.asarray(bias), jnp.asarray(bias_lens))
    j_state = jit(j_sc.init, static_argnums=(2, 3))(jnp.asarray(enc),
                                                        jnp.asarray(enc_lens[0]), K, LMAX)
    j_step = jit(j_sc.step)
    ctx = (torch.from_numpy(bias), torch.from_numpy(bias_lens))
    t_sc, set_sc, plain_sc = (CachedGuidedScorer(tmodel) for _ in range(3))
    set_sc.set_bias(*ctx)
    e, el = torch.from_numpy(enc), torch.from_numpy(enc_lens[:1])
    with torch.no_grad():
        states = [t_sc.init(e, el, K, LMAX, ctx=ctx), set_sc.init(e, el, K, LMAX),
                  plain_sc.init(e, el, K, LMAX)]
    tokens = np.full((K, LMAX), 1, np.int64)
    lens = np.ones(K, np.int64)
    chosen = [[11, 12, 13], [13, 11, 11], [12, 12, 13]]
    for step in range(3):
        j_logp, j_state = j_step(jnp.asarray(enc), jnp.asarray(enc_lens[0]), j_state,
                                 jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(step))
        out = []
        with torch.no_grad():
            for i, sc in enumerate((t_sc, set_sc, plain_sc)):
                logp, states[i] = sc.step(e, el, states[i], torch.from_numpy(tokens),
                                          torch.from_numpy(lens), step)
                out.append(logp.numpy())
        np.testing.assert_allclose(out[0], np.asarray(j_logp), rtol=1e-3, atol=2e-4)
        np.testing.assert_array_equal(out[0], out[1])
        assert not np.allclose(out[0], out[2], atol=1e-4)
        tokens[:, step + 1] = [chosen[k][step] for k in range(K)]
        lens += 1
        parent = np.array([2, 0, 1]) if step == 1 else np.arange(K)
        tokens = tokens[parent]
        j_state = j_sc.select(j_state, jnp.asarray(parent))
        states = [sc.select(s, torch.from_numpy(parent)) for sc, s in
                  zip((t_sc, set_sc, plain_sc), states)]


def test_biased_beam_and_speech2text_switching(biased):
    """The beam search with bias ids as scorer context against JAX's; then
    Speech2Text switching bias words between calls gives, on every call,
    what a fresh Speech2Text gives: nothing of an earlier call's bias is
    kept."""
    jmodel, variables, tmodel = biased
    rng = np.random.default_rng(7)
    wave = (rng.standard_normal(N) * 0.1).astype(np.float32)
    tok = HuggingFaceTokenizer(BPE_DIR)
    kw = dict(ctc_weight=0.3, beam_size=3, maxlenratio=-5.0, nbest=2, tokenizer=tok)
    s2t = Speech2Text.from_model(tmodel, **kw)
    ctx = s2t.make_bias_ctx(["abc", "cab"])
    assert ctx[0].shape == (1, 64) and int(ctx[1][0]) == len(
        LLMTokenizer.from_pretrained(BPE_DIR)("abc, cab")["input_ids"])
    assert s2t.make_bias_ctx([]) is None and s2t.make_bias_ctx(None) is None

    padded = np.zeros((1, 6400), np.float32)
    padded[0, :N] = wave
    j_enc, j_lens = jit(lambda s, n: jmodel.apply(variables, s, n, method=jmodel.encode))(
        jnp.asarray(padded), jnp.asarray([N]))
    j_bs = JBeamSearch(jmodel, variables, att_scorer=JCachedScorer(jmodel, variables),
                       vocab_size=V, sos=1, eos=1, beam_size=3, ctc_weight=0.3)
    j_hyps = j_bs(j_enc, j_lens, maxlenratio=-5.0, nbest=2,
                  scorer_ctx=tuple(jnp.asarray(x.numpy()) for x in ctx))
    t_hyps = BatchBeamSearch(tmodel, vocab_size=V, sos=1, eos=1, beam_size=3, ctc_weight=0.3,
                             att_scorer=CachedGuidedScorer(tmodel))(
        torch.from_numpy(np.array(j_enc)), torch.from_numpy(np.array(j_lens)),
        maxlenratio=-5.0, nbest=2, scorer_ctx=ctx)
    assert [h.yseq for h in t_hyps] == [h.yseq for h in j_hyps]
    for t, j in zip(t_hyps, j_hyps):
        np.testing.assert_allclose(t.score, j.score, atol=1e-3)

    calls = [["abc", "cab"], ["b"], None, ["abc", "cab"]]
    results = [s2t(wave, biasing_words=w) for w in calls]
    for words, got in zip(calls, results):
        want = Speech2Text.from_model(tmodel, **kw)(wave, biasing_words=words)
        assert [(r[0], r[2], r[3].yseq, r[3].score) for r in got] == \
            [(r[0], r[2], r[3].yseq, r[3].score) for r in want]
    text, tokens, ids, hyp = results[0][0]
    assert tokens == LLMTokenizer.from_pretrained(BPE_DIR).convert_ids_to_tokens(ids)
    assert text == " ".join(tokens).strip()
    assert results[0][0][3].score != results[1][0][3].score


def test_log_softmax_mode_matches_jax():
    """decode_step scores with the LLM's own next-token log-probs: against
    JAX's within 1e-4 over three cached steps, and at step 0 against the
    uncached LLM forward over [prompt | sos]."""
    jmodel, variables, tmodel = _models(seed=1, llm_score_mode="log_softmax")
    enc, enc_lens = _enc(b=1, seed=8)
    K, LMAX = 2, 5
    j_sc = JCachedScorer(jmodel, variables)
    j_state = jit(j_sc.init, static_argnums=(2, 3))(jnp.asarray(enc),
                                                        jnp.asarray(enc_lens[0]), K, LMAX)
    j_step = jit(j_sc.step)
    t_sc = CachedGuidedScorer(tmodel)
    e, el = torch.from_numpy(enc), torch.from_numpy(enc_lens[:1])
    with torch.no_grad():
        t_state = t_sc.init(e, el, K, LMAX)
    tokens = np.full((K, LMAX), 1, np.int64)
    lens = np.ones(K, np.int64)
    for step in range(3):
        j_logp, j_state = j_step(jnp.asarray(enc), jnp.asarray(enc_lens[0]), j_state,
                                 jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(step))
        with torch.no_grad():
            t_logp, t_state = t_sc.step(e, el, t_state, torch.from_numpy(tokens),
                                        torch.from_numpy(lens), step)
        np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), atol=1e-4, rtol=0)
        if step == 0:
            with torch.no_grad():
                hyp, hyp_lens = tmodel._first_pass_hyp(e, el)
                ids, valid, start = tmodel._pack(hyp, hyp_lens, torch.ones((1, 1), dtype=torch.int64),
                                                 torch.ones(1, dtype=torch.int64), None, None)
                _, logits, _ = tmodel.llm(ids, valid, return_logits=True)
            want = torch.log_softmax(logits[0, int(start[0])], dim=-1)
            np.testing.assert_allclose(t_logp[0].numpy(), want.numpy(), atol=1e-5)
        tokens[:, step + 1] = [11 + step, 13]
        lens += 1


def test_mixed_vocab_first_pass_and_loss_match_jax():
    """CTC over its own 7-token vocabulary, the first pass expanded to LLM
    ids through the CTC map (empty for specials, two ids for "ab"); the
    loss takes CTC-vocab targets."""
    jmodel, variables, tmodel = _models(seed=2, ctc_vocab_size=len(CTC_TOKENS), ctc_map_width=3)
    rng = np.random.default_rng(9)
    enc = rng.standard_normal((3, 24, 32)).astype(np.float32) * 4.0  # a peaked CTC head
    enc_lens = np.array([24, 17, 5])
    j_hyp, j_n = jit(lambda e, n: jmodel.apply(variables, e, n,
                                                   method=jmodel._first_pass_hyp))(
        jnp.asarray(enc), jnp.asarray(enc_lens))
    with torch.no_grad():
        t_hyp, t_n = tmodel._first_pass_hyp(torch.from_numpy(enc), torch.from_numpy(enc_lens))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    np.testing.assert_array_equal(t_hyp.numpy(), np.asarray(j_hyp))
    assert int(t_n.max()) > 0

    speech = (rng.standard_normal((2, N)) * 0.1).astype(np.float32)
    slens, text, tlens = np.array([N, 4500]), np.array([[11, 12, 13], [13, -1, -1]]), np.array([3, 1])
    ctc_text, ctc_lens = np.array([[2, 3], [3, -1]]), np.array([2, 1])
    j_loss, j_stats, _ = jit(lambda *a: jmodel.apply(variables, *a[:4], ctc_text=a[4],
                                                         ctc_text_lengths=a[5]))(
        *(jnp.asarray(x) for x in (speech, slens, text, tlens, ctc_text, ctc_lens)))
    T = torch.from_numpy
    with torch.no_grad():
        t_loss, t_stats, _ = tmodel(T(speech), T(slens), T(text), T(tlens), ctc_text=T(ctc_text),
                                    ctc_text_lengths=T(ctc_lens))
        with pytest.raises(ValueError, match="ctc_text"):
            tmodel(T(speech), T(slens), T(text), T(tlens))
    for name in ("loss", "loss_att", "loss_ctc"):
        np.testing.assert_allclose(float(t_stats[name]), float(j_stats[name]), rtol=2e-4)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=2e-4)
    with pytest.raises(ValueError, match="mixed-vocab"):
        BatchBeamSearch(tmodel, vocab_size=V, sos=1, eos=1, beam_size=2, ctc_weight=0.3)(
            torch.from_numpy(enc[:1]), torch.from_numpy(enc_lens[:1]))
