"""Port vs JAX: the prompt template split (with and without ((BIAS))), the
bias segment of pack_prompt, and the mixed-vocab CTC map (build_ctc_to_llm_map,
expand_token_ids).  The JAX side tokenizes with transformers.AutoTokenizer,
the port with its own reader of tokenizer.json."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import AutoTokenizer

from llm_guided_asr_tpu.models.llm import prompt as jp
from llm_guided_asr_tpu.utils.testing import make_tiny_llm_dir
from llm_guided_asr_tpu_torch.models.llm import prompt as tp
from llm_guided_asr_tpu_torch.text.tokenizers import LLMTokenizer

torch.set_num_threads(1)

BPE_DIR = Path(__file__).resolve().parent / "parity" / "tiny_llm_bpe"
TEMPLATES = [None, 'fix "((HYP))" then reply: ', 'fix "((HYP))" -> "',
             'words: ((BIAS)) fix "((HYP))" -> "', "((BIAS))((HYP))"]
CTC_TOKENS = ["<blank>", "<unk>", "ab", "c", "a", "b", "▁a", "ĠHY", "((", "<sos/eos>"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {"bpe": BPE_DIR,
            "wordlevel": make_tiny_llm_dir(tmp_path_factory.mktemp("tiny_llm_pr") / "model")}


@pytest.mark.parametrize("kind", ["bpe", "wordlevel"])
@pytest.mark.parametrize("template", TEMPLATES)
@pytest.mark.parametrize("pad_token", [None, "<unk>"])
def test_split_template_matches_jax(dirs, kind, template, pad_token):
    j = jp.split_template(AutoTokenizer.from_pretrained(dirs[kind]), template, 51, 52, pad_token)
    t = tp.split_template(LLMTokenizer.from_pretrained(dirs[kind]), template, 51, 52, pad_token)
    assert t.prefix_ids == j.prefix_ids and t.suffix_ids == j.suffix_ids
    assert t.mid_ids == j.mid_ids and t.has_bias_slot == j.has_bias_slot
    assert (t.start_of_response_id, t.end_of_response_id, t.pad_id) == (
        j.start_of_response_id, j.end_of_response_id, j.pad_id)


def test_split_template_without_marker_raises(dirs):
    with pytest.raises(ValueError, match="HYP"):
        tp.split_template(LLMTokenizer.from_pretrained(dirs["bpe"]), "no marker", 51, 52)


def test_pack_prompt_with_bias_matches_jax():
    """The JAX biasing test's case, then ragged rows with empty segments;
    a template without a bias slot ignores bias ids."""
    rng = np.random.default_rng(0)
    with_bias = dict(prefix_ids=(9, 3), suffix_ids=(7,), start_of_response_id=5,
                     end_of_response_id=5, pad_id=0, mid_ids=(8, 6))
    for fields in (with_bias, {**with_bias, "mid_ids": None}, {**with_bias, "mid_ids": ()}):
        b = 4
        bias = rng.integers(20, 40, (b, 5))
        bias_lens = np.array([2, 0, 5, 3])
        hyp = rng.integers(10, 20, (b, 3))
        hyp_lens = np.array([1, 3, 0, 2])
        resp = rng.integers(40, 50, (b, 4))
        resp_lens = np.array([2, 4, 1, 0])
        j = jp.pack_prompt(jp.PromptTemplate(**fields), *(jnp.asarray(x, jnp.int32) for x in (
            hyp, hyp_lens, resp, resp_lens, bias, bias_lens)))
        t = tp.pack_prompt(tp.PromptTemplate(**fields), *(torch.from_numpy(x) for x in (
            hyp, hyp_lens, resp, resp_lens, bias, bias_lens)))
        for got, want in zip(t, j):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids, valid, start = tp.pack_prompt(
        tp.PromptTemplate(prefix_ids=(9,), suffix_ids=(7,), start_of_response_id=5,
                          end_of_response_id=5, pad_id=0, mid_ids=(8,)),
        torch.tensor([[11, 0]]), torch.tensor([1]), torch.tensor([[5, 21]]), torch.tensor([2]),
        torch.tensor([[31, 32, 0]]), torch.tensor([2]))
    assert ids[0][valid[0]].tolist() == [9, 31, 32, 8, 11, 7, 5, 21] and int(start[0]) == 6


def test_expand_token_ids_matches_jax():
    """Random CTC hypotheses over a map with empty expansions (specials)
    and full-width ones, lengths from 0 to the row width."""
    rng = np.random.default_rng(1)
    vc, width = 12, 3
    lens = rng.integers(0, width + 1, vc)
    lens[[0, 1, vc - 1]] = 0  # blank, unk, sos/eos expand to nothing
    ids = np.where(np.arange(width)[None] < lens[:, None], rng.integers(1, 60, (vc, width)), 0)
    hyp = rng.integers(0, vc, (5, 7))
    hyp_lens = np.array([7, 0, 3, 1, 6])
    j_ids, j_lens = jp.expand_token_ids(*(jnp.asarray(x, jnp.int32) for x in (
        ids, lens, hyp, hyp_lens)), pad_id=99)
    t_ids, t_lens = tp.expand_token_ids(*(torch.from_numpy(x) for x in (ids, lens, hyp,
                                                                         hyp_lens)), pad_id=99)
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    # the JAX mixed-vocab test's hand-made case
    t_ids, t_lens = tp.expand_token_ids(
        torch.tensor([[0, 0], [10, 11], [12, 0], [0, 0]]), torch.tensor([0, 2, 1, 0]),
        torch.tensor([[1, 2, 1, 0], [3, 2, 0, 0]]), torch.tensor([3, 2]), pad_id=99)
    assert t_lens.tolist() == [5, 1]
    assert t_ids.tolist() == [[10, 11, 12, 10, 11, 99, 99, 99], [12] + [99] * 7]


@pytest.mark.parametrize("kind", ["bpe", "wordlevel"])
def test_ctc_to_llm_map_matches_jax(dirs, kind):
    j_ids, j_lens = jp.build_ctc_to_llm_map(CTC_TOKENS, AutoTokenizer.from_pretrained(dirs[kind]),
                                            max_expand=3)
    t_ids, t_lens = tp.build_ctc_to_llm_map(CTC_TOKENS, LLMTokenizer.from_pretrained(dirs[kind]),
                                            max_expand=3)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_lens, j_lens)
    assert t_lens[0] == t_lens[1] == t_lens[-1] == 0
