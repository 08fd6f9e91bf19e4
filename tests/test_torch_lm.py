"""Port vs JAX: the language models of models/lm.py and tasks/lm.py's
build_lm, on the same seeded weights and tokens; 1e-5 abs + 1e-5 rel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import lm as jlm
from llm_guided_asr_tpu.search.beam_search import Hypothesis as JHypothesis
from llm_guided_asr_tpu.tasks.lm import build_lm as j_build_lm
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import lm as tlm
from llm_guided_asr_tpu_torch.search.beam_search import Hypothesis
from llm_guided_asr_tpu_torch.tasks.lm import build_lm
from test_torch_train import jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

V = 11
TOKENS = np.array([[10, 3, 4, 7, 1, 2], [10, 5, 9, 0, 0, 0], [10, 2, 2, 8, 6, 0]], np.int64)
LENGTHS = np.array([6, 3, 5], np.int64)
TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    "transformer": lambda m: m.TransformerLMConfig(vocab_size=V, embed_unit=16, att_unit=32,
                                                   head=2, unit=48, layer=2, dropout_rate=0.0),
    "lstm": lambda m: m.SequentialRNNLMConfig(vocab_size=V, unit=24, nlayers=2, rnn_type="lstm"),
    "gru": lambda m: m.SequentialRNNLMConfig(vocab_size=V, unit=24, nlayers=2, rnn_type="gru"),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _lms(kind):
    """(JAX ESPnetLanguageModel, its variables, the port's with the same weights)."""
    jcls = jlm.TransformerLM if kind == "transformer" else jlm.SequentialRNNLM
    tcls = tlm.TransformerLM if kind == "transformer" else tlm.SequentialRNNLM
    jmodel = jlm.ESPnetLanguageModel(lm=jcls(CONFIGS[kind](jlm)), vocab_size=V)
    variables = seeded_variables(jmodel, jnp.asarray(TOKENS, jnp.int32),
                                 jnp.asarray(LENGTHS, jnp.int32), seed=5)
    tmodel = tlm.ESPnetLanguageModel(tcls(CONFIGS[kind](tlm), device="cpu"), V)
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_lm_logits_and_nll_match_jax(kind):
    jmodel, variables, tmodel = _lms(kind)
    lm_vars = {"params": variables["params"]["lm"]}
    toks, lens = jnp.asarray(TOKENS, jnp.int32), jnp.asarray(LENGTHS, jnp.int32)
    want = jit(jmodel.lm.apply)(lm_vars, toks, lens)
    with torch.no_grad():
        got = tmodel.lm(torch.from_numpy(TOKENS), torch.from_numpy(LENGTHS))
    valid = np.arange(TOKENS.shape[1])[None] < LENGTHS[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **TOL)
    if kind != "transformer":  # the recurrence runs over the pads too, as in JAX
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    text = np.where(valid, TOKENS, -1)
    j_nll, j_cnt = jit(functools.partial(jmodel.apply, method=jmodel.nll))(
        variables, jnp.asarray(text, jnp.int32), lens)
    with torch.no_grad():
        t_nll, t_cnt = tmodel.nll(torch.from_numpy(text), torch.from_numpy(LENGTHS))
        t_loss, stats, weight = tmodel(torch.from_numpy(text), torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(t_nll.numpy(), np.asarray(j_nll), **TOL)
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    j_loss, j_stats, j_weight = jit(jmodel.apply)(variables, jnp.asarray(text, jnp.int32), lens)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), **TOL)
    np.testing.assert_allclose(stats["perplexity"].item(), float(j_stats["perplexity"]), **TOL)
    assert weight.item() == float(j_weight) == 3.0


@pytest.mark.parametrize("kind", ["transformer", "lstm"])
def test_lm_score_fn_matches_jax(kind):
    """The beam search's full scorer: the log-probs after each row's prefix."""
    jmodel, variables, tmodel = _lms(kind)
    jscore = jlm.make_lm_score_fn(jmodel.lm, {"params": variables["params"]["lm"]})
    want = jit(jscore)(jnp.asarray(TOKENS, jnp.int32), jnp.asarray(LENGTHS, jnp.int32))
    with torch.no_grad():
        got = tlm.make_lm_score_fn(tmodel.lm)(torch.from_numpy(TOKENS), torch.from_numpy(LENGTHS))
    assert got.dtype == torch.float32 and got.shape == (3, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lm_rescore_nbest_matches_jax():
    """Totals and the new order (the LM term reorders the two best)."""
    jmodel, variables, tmodel = _lms("transformer")
    seqs = [[10, 3, 4, 10], [10, 5, 9, 7, 10], [10, 10], [10, 2, 2, 8, 10]]
    scores = [-1.0, -1.1, -4.0, -1.05]
    jh = [JHypothesis(yseq=s, score=x, scores={"ctc": x}) for s, x in zip(seqs, scores)]
    th = [Hypothesis(yseq=s, score=x, scores={"ctc": x}) for s, x in zip(seqs, scores)]
    want = jlm.lm_rescore_nbest(jh, jmodel, variables, weight=0.5, sos=10, eos=10)
    got = tlm.lm_rescore_nbest(th, tmodel, weight=0.5, sos=10, eos=10)
    assert [h.yseq for h in got] == [h.yseq for h in want]
    by_score = [seqs[i] for i in np.argsort(-np.asarray(scores), kind="stable")]
    assert [h.yseq for h in got] != by_score  # the LM term reorders them
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.score, w.score, **TOL)
        np.testing.assert_allclose(g.scores["lm_rescore"], w.scores["lm_rescore"], **TOL)
        assert g.scores["ctc"] == w.scores["ctc"]


@pytest.mark.parametrize("lm", ["transformer", "seq_rnn"])
def test_build_lm_matches_jax(lm, tmp_path):
    """A token-list file and an lm_conf (with a key the config does not know,
    dropped by both) build the same LM; its weights carry over."""
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("\n".join(f"t{i}" for i in range(V)) + "\n")
    conf = ({"embed_unit": 8, "att_unit": 16, "head": 2, "unit": 24, "layer": 1,
             "dropout_rate": 0.0, "bogus": 1} if lm == "transformer"
            else {"unit": 12, "nlayers": 1, "rnn_type": "gru", "bogus": 1})
    config = {"token_list": str(tokens), "lm": lm, "lm_conf": conf}
    jmodel = j_build_lm(config)
    tmodel = build_lm(config, device="cpu")
    assert tmodel.vocab_size == jmodel.vocab_size == V
    assert dataclasses_equal(tmodel.lm.cfg, jmodel.lm.cfg)
    variables = seeded_variables(jmodel, jnp.asarray(TOKENS, jnp.int32),
                                 jnp.asarray(LENGTHS, jnp.int32), seed=6)
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    with pytest.raises(ValueError, match="unknown lm type"):
        build_lm({**config, "lm": "bogus"}, device="cpu")


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_transformer_lm_refuses_pos_enc_none():
    """The JAX TransformerLM adds the sinusoidal encoding even for
    pos_enc=None, the reference adds none: the port does neither silently."""
    cfg = tlm.TransformerLMConfig(vocab_size=V, pos_enc=None)
    with pytest.raises(ValueError, match="pos_enc=None"):
        tlm.TransformerLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="only 'sinusoidal'"):
        tlm.TransformerLM(tlm.TransformerLMConfig(vocab_size=V, pos_enc="abs"), device="cpu")


def test_transformer_lm_norm_eps():
    """input_norm and after_norm are bare flax LayerNorms (eps 1e-6); the
    encoder layers' norms take 1e-5."""
    _, _, tmodel = _lms("transformer")
    lm = tmodel.lm
    assert lm.input_norm.eps == lm.after_norm.eps == 1e-6
    assert lm.block_0.norm1.eps == lm.block_1.norm2.eps == 1e-5
