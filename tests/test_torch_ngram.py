"""Port vs JAX: the n-gram LM of search/ngram.py -- the ARPA text written
from the tone corpus's transcripts, backoff scores, n-best rescoring, and
the dense tables and score function of on-device fusion (all exact)."""

import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.search import ngram as jng
from llm_guided_asr_tpu.search.beam_search import Hypothesis as JHypothesis
from llm_guided_asr_tpu_torch.bin.golden_check import TONE_TOKENS, make_tone_corpus
from llm_guided_asr_tpu_torch.search import ngram as tng
from llm_guided_asr_tpu_torch.search.beam_search import Hypothesis

torch.set_num_threads(1)

SENTENCES = [list(text) for _, text in make_tone_corpus().values()]


@pytest.fixture(scope="module")
def arpas(tmp_path_factory):
    """{order: (JAX file, port file)} of ARPA models of the corpus; the JAX
    function fails at order 1 (it takes <s>'s backoff weight), so that one
    is the port's alone."""
    root = tmp_path_factory.mktemp("arpa")
    out = {1: (None, tng.build_arpa(SENTENCES, root / "t1.arpa", order=1))}
    for order in (2, 3):
        out[order] = (jng.build_arpa(SENTENCES, root / f"j{order}.arpa", order=order),
                      tng.build_arpa(SENTENCES, root / f"t{order}.arpa", order=order))
    return out


def test_unigram_arpa(arpas):
    """Order 1: no backoff column, probabilities interpolated with the
    uniform distribution and summing to 1 over the vocabulary."""
    _, tpath = arpas[1]
    lm = tng.ArpaLM(tpath)
    assert lm.order == 1 and lm.backoff == [{}]
    assert "-99\t<s>\n" in tpath.read_text()
    total = sum(np.exp(lp) for (w,), lp in lm.logp[0].items() if w != "<s>")
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)
    np.testing.assert_allclose(lm.score_sequence(list("ab")),
                               sum(lm.logp[0][(w,)] for w in ("a", "b", "</s>")), rtol=1e-12)


@pytest.mark.parametrize("order", [2, 3])
def test_build_arpa_and_scores_match_jax(arpas, order):
    jpath, tpath = arpas[order]
    assert tpath.read_text() == jpath.read_text()
    assert "\\end\\" in tpath.read_text()
    jlm, tlm = jng.ArpaLM(jpath), tng.ArpaLM(tpath)
    assert tlm.order == jlm.order == order
    for ctx, word in ((["<s>"], "a"), (["a", "b"], "c"), (["c", "c"], "</s>"),
                      (["b"], "<unk>"), (["a", "zz"], "b"), ([], "zz")):
        assert tlm.score_word(ctx, word) == jlm.score_word(ctx, word)
    for sent in SENTENCES[:6] + [["a", "zz", "c"], []]:
        assert tlm.score_sequence(sent) == jlm.score_sequence(sent)


def test_ngram_rescorer_matches_jax(arpas):
    _, tpath = arpas[3]
    toks = [list("abc"), list("cca"), list("ba"), list("aaaa")]
    scores = [-2.0, -2.1, -1.9, -2.05]
    want = jng.NgramRescorer(tpath, weight=0.7)(
        [JHypothesis(yseq=[i], score=x, scores={}) for i, x in enumerate(scores)], toks)
    got = tng.NgramRescorer(tpath, weight=0.7)(
        [Hypothesis(yseq=[i], score=x, scores={}) for i, x in enumerate(scores)], toks)
    assert [h.yseq for h in got] == [h.yseq for h in want]
    assert [h.yseq[0] for h in got] != list(np.argsort(-np.asarray(scores)))
    assert [h.score for h in got] == [h.score for h in want]


@pytest.mark.parametrize("order", [1, 2])
def test_dense_ngram_scorer_matches_jax(arpas, order):
    """Tables and the score function over prefixes of lengths 1 (the
    unigram) and more, with an id past the vocabulary clipped; the JAX
    scorer reads the port's files (the order-1 one included)."""
    _, tpath = arpas[order]
    jd = jng.DenseNgramScorer(tpath, TONE_TOKENS)
    td = tng.DenseNgramScorer(tpath, TONE_TOKENS, device="cpu")
    np.testing.assert_array_equal(td.table.numpy(), np.asarray(jd.table))
    np.testing.assert_array_equal(td.uni.numpy(), np.asarray(jd.uni))
    tokens = np.array([[5, 2, 3, 0], [5, 0, 0, 0], [5, 4, 4, 2], [5, 9, 0, 0]], np.int64)
    lens = np.array([3, 1, 4, 2], np.int64)
    want = jd.make_score_fn()(tokens.astype(np.int32), lens.astype(np.int32))
    got = td.make_score_fn()(torch.from_numpy(tokens), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dense_ngram_scorer_vocabulary_limit(arpas):
    _, tpath = arpas[2]
    with pytest.raises(ValueError, match="4096"):
        tng.DenseNgramScorer(tpath, [f"t{i}" for i in range(4097)], device="cpu")
    assert tng.DenseNgramScorer(tpath, [f"t{i}" for i in range(4096)], device="cpu").table.shape \
        == (4096, 4096)
