"""Port vs JAX: the search pieces of the slice -- greedy CTC, prompt
packing and CTC prefix scoring -- on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
from llm_guided_asr_tpu.models.llm.prompt import pack_prompt as j_pack_prompt
from llm_guided_asr_tpu.search import ctc_prefix as jcp
from llm_guided_asr_tpu.search.greedy import ctc_greedy_decode as j_greedy
from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate, pack_prompt
from llm_guided_asr_tpu_torch.search import ctc_prefix as tcp
from llm_guided_asr_tpu_torch.search.greedy import ctc_greedy_decode

torch.set_num_threads(1)

PROMPT = dict(prefix_ids=(2, 3, 4), suffix_ids=(5, 6), start_of_response_id=7,
              end_of_response_id=7, pad_id=0)


def test_greedy_and_prompt_packing_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 17, 9)).astype(np.float32)
    logits[:, ::3, 0] += 3.0  # some blanks
    logits[:, 5:8, 4] += 5.0  # a repeated token
    lens = np.array([17, 11, 0], np.int32)
    j_tok, j_n = j_greedy(jnp.asarray(logits), jnp.asarray(lens), pad_id=1)
    t_tok, t_n = ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens).long(), pad_id=1)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))

    resp = rng.integers(8, 40, (3, 4)).astype(np.int32)
    resp_lens = np.array([4, 1, 0], np.int32)
    j_out = j_pack_prompt(JPromptTemplate(**PROMPT), j_tok, j_n, jnp.asarray(resp),
                          jnp.asarray(resp_lens))
    t_out = pack_prompt(PromptTemplate(**PROMPT), t_tok, t_n, torch.from_numpy(resp).long(),
                        torch.from_numpy(resp_lens).long())
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_ctc_prefix_scoring_matches_jax():
    """One lane (the port's functions take a leading lane axis) against the
    JAX functions of one utterance."""
    rng = np.random.default_rng(2)
    t_max, k = 21, 3
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((t_max, 11)) * 2), -1))
    length = jnp.asarray(17)
    t_logp, t_len = torch.from_numpy(np.array(logp))[None], torch.tensor([17])
    j_state = jcp.ctc_prefix_init(jnp.asarray(logp), length, k)
    t_state = tcp.ctc_prefix_init(t_logp, t_len, k)
    for step in range(3):
        cand = rng.integers(0, 11, (k, 5)).astype(np.int32)
        cand[:, -1] = 10  # eos
        j_psi = jcp.ctc_prefix_psi(jnp.asarray(logp), length, j_state, jnp.asarray(cand), eos_id=10)
        t_psi = tcp.ctc_prefix_psi(t_logp, t_len, t_state, torch.from_numpy(cand).long()[None],
                                   eos_id=10)[0]
        np.testing.assert_allclose(t_psi.numpy(), np.asarray(j_psi), rtol=1e-5, atol=1e-4)
        parent = np.array([0, 0, 1]) if step else np.zeros(k, np.int64)
        cidx = np.array([1, 2, 0])
        token = cand[parent, cidx]
        token[token == 0] = 3  # a label, not blank
        j_state = jcp.ctc_prefix_advance(jnp.asarray(logp), length, j_state, jnp.asarray(token),
                                         jnp.asarray(parent), j_psi[parent, cidx])
        t_state = tcp.ctc_prefix_advance(t_logp, t_len, t_state,
                                         torch.from_numpy(token).long()[None],
                                         torch.from_numpy(parent)[None], t_psi[parent, cidx][None])
        valid = np.arange(t_max) < 17  # rows past the length are never read
        np.testing.assert_allclose(t_state.r.numpy()[0][:, valid], np.asarray(j_state.r)[:, valid],
                                   rtol=1e-5, atol=1e-3)
