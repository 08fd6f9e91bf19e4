"""Port vs JAX: shallow LM fusion in the beam search -- a Transformer LM and
the dense n-gram as the full scorer at lm_weight 0.5, pre-beam ratios 1.5
and 2.0 -- one utterance at a time and in a lockstep batch (each lane equal
to its lone decode), and Speech2Text with an LM."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import lm as jlm
from llm_guided_asr_tpu.search import ngram as jng
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text, round_up
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import lm as tlm
from llm_guided_asr_tpu_torch.search import ngram as tng
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
from test_torch_batch_decode import ENC_LENS, _asr_models, _check_batch, _enc, _same
from test_torch_transducer import seeded_variables

V = 8  # the vocabulary of test_torch_batch_decode's ASRModel (sos = eos = 7)
LM_WEIGHT = 0.5
TOKENS = [f"t{i}" for i in range(V)]


@pytest.fixture(scope="module")
def asr():
    return _asr_models()


@functools.lru_cache(maxsize=None)
def _transformer_lms():
    """(JAX score fn, the port's TransformerLM) with the same seeded weights."""
    cfg = dict(vocab_size=V, embed_unit=12, att_unit=16, head=2, unit=24, layer=2,
               dropout_rate=0.0)
    jmodel = jlm.TransformerLM(jlm.TransformerLMConfig(**cfg))
    variables = seeded_variables(jmodel, jnp.ones((2, 4), jnp.int32), jnp.asarray([4, 2]),
                                 seed=11)
    tmodel = tlm.TransformerLM(tlm.TransformerLMConfig(**cfg), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)),
                           strict=True)
    return jax.jit(jlm.make_lm_score_fn(jmodel, variables)), tmodel.eval()


@functools.lru_cache(maxsize=None)
def _ngram_path(root):
    """A trigram over the 8 ids from seeded sentences of 1-6 tokens (the
    blank and eos ids are never words, as in a transcript)."""
    rng = np.random.default_rng(13)
    sents = [[TOKENS[i] for i in rng.integers(1, V - 1, rng.integers(1, 7))] for _ in range(60)]
    return tng.build_arpa(sents, root / "ids.arpa", order=3)


def _scorers(kind, tmp_path_factory):
    if kind == "transformer":
        jscore, tmodel = _transformer_lms()
        return jscore, tlm.make_lm_score_fn(tmodel)
    path = _ngram_path(tmp_path_factory.getbasetemp())
    return (jng.DenseNgramScorer(path, TOKENS).make_score_fn(),
            tng.DenseNgramScorer(path, TOKENS, device="cpu").make_score_fn())


def _searches(asr, kind, ratio, tmp_path_factory, beam_size=3):
    jmodel, variables, tmodel = asr
    jscore, tscore = _scorers(kind, tmp_path_factory)
    common = dict(vocab_size=V, sos=7, eos=7, beam_size=beam_size, ctc_weight=0.3,
                  lm_weight=LM_WEIGHT, pre_beam_ratio=ratio)
    return (JBeamSearch(jmodel, variables, lm_score_fn=jscore, **common),
            BatchBeamSearch(tmodel, lm_score_fn=tscore, **common))


def _check_parts(hyps):
    """Each hypothesis's score is its weighted parts; the LM part is there."""
    for h in hyps:
        assert set(h.scores) == {"decoder", "ctc", "lm"}
        want = 0.7 * h.scores["decoder"] + 0.3 * h.scores["ctc"] + LM_WEIGHT * h.scores["lm"]
        np.testing.assert_allclose(h.score, want, atol=1e-4)


@pytest.mark.parametrize("ratio", [1.5, 2.0])
@pytest.mark.parametrize("kind", ["transformer", "ngram"])
def test_lm_fusion_matches_jax(asr, kind, ratio, tmp_path_factory):
    """The lockstep batch of three ragged utterances against JAX's and
    against the port's lone decodes (nbest 2: hypotheses, scores within
    1e-4), and each hypothesis's parts, "lm" included, against JAX's."""
    j_bs, t_bs = _searches(asr, kind, ratio, tmp_path_factory)
    assert t_bs.W == j_bs.W == int(ratio * 3)
    enc = _enc(16, seed=3)
    got = _check_batch(j_bs, t_bs, enc, maxlenratio=-6.0)
    want = j_bs.batch_decode(jnp.asarray(enc), jnp.asarray(ENC_LENS), nbest=2, maxlenratio=-6.0)
    for g_lane, w_lane in zip(got, want):
        for g, w in zip(g_lane, w_lane):
            assert set(g.scores) == set(w.scores) == {"decoder", "ctc", "lm"}
            for key in w.scores:
                np.testing.assert_allclose(g.scores[key], w.scores[key], atol=1e-4)
        _check_parts(g_lane)
    assert any(len(lane[0].yseq) > 3 for lane in got)


def test_lm_changes_the_search(asr, tmp_path_factory):
    """The LM term is not idle: without it (or at weight 0) the top
    hypotheses differ somewhere in the batch, and weight 0 is the plain
    search bit for bit."""
    _, _, tmodel = asr
    _, t_bs = _searches(asr, "transformer", 1.5, tmp_path_factory)
    plain = BatchBeamSearch(tmodel, vocab_size=V, sos=7, eos=7, beam_size=3, ctc_weight=0.3)
    idle = BatchBeamSearch(tmodel, vocab_size=V, sos=7, eos=7, beam_size=3, ctc_weight=0.3,
                           lm_score_fn=t_bs.lm_score_fn, lm_weight=0.0)
    enc, lens = torch.from_numpy(_enc(16, seed=3)), torch.from_numpy(ENC_LENS)
    fused = t_bs.batch_decode(enc, lens, maxlenratio=-6.0)
    base = plain.batch_decode(enc, lens, maxlenratio=-6.0)
    assert [h[0].yseq for h in fused] != [h[0].yseq for h in base]
    assert idle.batch_decode(enc, lens, maxlenratio=-6.0) == base


def test_speech2text_with_lm_matches_jax(asr, tmp_path_factory):
    """Speech2Text(lm=...) with an ESPnetLanguageModel, a bare LM and a
    score function: the JAX search with the same LM over JAX's encoding of
    the same padded waveform."""
    jmodel, variables, tmodel = asr
    jscore, tmodel_lm = _transformer_lms()
    rng = np.random.default_rng(14)
    wave = rng.standard_normal(2600).astype(np.float32)
    padded = np.zeros(round_up(len(wave), 1600), np.float32)
    padded[: len(wave)] = wave
    enc, enc_lens = jax.jit(functools.partial(jmodel.apply, method=jmodel.encode))(
        variables, jnp.asarray(padded[None]), jnp.asarray([len(wave)]))
    j_bs = JBeamSearch(jmodel, variables, vocab_size=V, sos=7, eos=7, beam_size=3,
                       ctc_weight=0.3, lm_score_fn=jscore, lm_weight=LM_WEIGHT, pre_beam_ratio=2.0)
    want = j_bs(enc, enc_lens, nbest=2, maxlenratio=-6.0)
    wrapped = tlm.ESPnetLanguageModel(tmodel_lm, V)
    for lm in (wrapped, tmodel_lm, tlm.make_lm_score_fn(tmodel_lm)):
        s2t = Speech2Text.from_model(tmodel, ctc_weight=0.3, beam_size=3, nbest=2,
                                     maxlenratio=-6.0, lm=lm,
                          lm_weight=LM_WEIGHT, pre_beam_ratio=2.0)
        got = s2t(wave)
        assert [ids for ids, _ in got] == [[t for t in h.yseq if t != 7] for h in want]
        _same([h for _, h in got], want)
    assert Speech2Text.from_model(tmodel, ctc_weight=0.3, beam_size=3).lm_weight == 0.0
