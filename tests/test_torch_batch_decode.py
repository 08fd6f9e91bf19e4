"""Port vs JAX: the lockstep batched beam search (batch_decode) with the
stateless scorer and the cached guided scorer, the standard decoder's
KV-cached scorer, Speech2Text.batch_call, and the lane axis of the CTC
prefix functions, which leaves one lane's numbers bit for bit as the
single-utterance functions computed them before it."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import llm_guided as jlg
from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
from llm_guided_asr_tpu.models.transformer_decoder import TransformerDecoderConfig as JDecConfig
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.search.cached_decoder import CachedDecoderScorer as JCachedDecoder
from llm_guided_asr_tpu.search.scorers import CachedGuidedScorer as JCachedScorer
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import llm_guided as tlg
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.search import ctc_prefix as tcp
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
from llm_guided_asr_tpu_torch.search.cached_decoder import CachedDecoderScorer
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer
from test_torch_guided_options import _fill

# tests/test_batch_decode.py:14 (the stateless case)
ASR = dict(frontend=dict(n_fft=128, hop_length=64, n_mels=20),
           encoder=dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1,
                        use_cnn_module=False),
           decoder=dict(attention_heads=2, linear_units=24, num_blocks=1))
GV = 50  # the guided model of tests/test_torch_llm_guided.py
GUIDED = dict(llm=dict(vocab_size=GV, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2),
              prompt=dict(prefix_ids=(2, 3, 4), suffix_ids=(5, 6), start_of_response_id=7,
                          end_of_response_id=7, pad_id=0),
              encoder=dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=1,
                           use_cnn_module=False),
              decoder=dict(attention_heads=2, linear_units=64, num_blocks=2))
ENC_LENS = np.array([21, 14, 7])  # three ragged utterances


def _enc(d, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    enc = (rng.standard_normal((3, 21, d)) * scale).astype(np.float32)
    for b, n in enumerate(ENC_LENS):
        enc[b, n:] = rng.standard_normal((21 - n, d))  # pad frames hold junk
    return enc


def _asr_models():
    common = dict(vocab_size=8, normalize="utterance_mvn", ctc_weight=0.3)
    jmodel = JASRModel(JASRModelConfig(
        frontend=JFrontendConfig(**ASR["frontend"]), encoder=JConformerConfig(**ASR["encoder"]),
        decoder=JDecConfig(**ASR["decoder"]), **common))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2048)), jnp.asarray([2048]),
        jnp.ones((1, 3), jnp.int32), jnp.asarray([3])))
    variables = _fill(shapes, 3)
    tmodel = ASRModel(ASRModelConfig(
        frontend=FrontendConfig(**ASR["frontend"]), encoder=ConformerConfig(**ASR["encoder"]),
        decoder=TransformerDecoderConfig(**ASR["decoder"]), **common), device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def asr():
    return _asr_models()


def _same(t_hyps, j_hyps, atol=1e-4):
    assert [h.yseq for h in t_hyps] == [h.yseq for h in j_hyps]
    np.testing.assert_allclose([h.score for h in t_hyps], [h.score for h in j_hyps],
                               rtol=0, atol=atol)


def _check_batch(j_bs, t_bs, enc, **kw):
    """JAX batch_decode == the port's batch_decode == the port's
    single-utterance calls, lane by lane (nbest 2)."""
    j_out = j_bs.batch_decode(jnp.asarray(enc), jnp.asarray(ENC_LENS), nbest=2, **kw)
    te, tl = torch.from_numpy(enc), torch.from_numpy(ENC_LENS)
    t_out = t_bs.batch_decode(te, tl, nbest=2, **kw)
    assert len(t_out) == 3 and all(len(h) == 2 for h in t_out)
    for b in range(3):
        _same(t_out[b], j_out[b])
        _same(t_out[b], t_bs(te[b:b + 1], tl[b:b + 1], nbest=2, **kw))
    assert len({tuple(h[0].yseq) for h in t_out}) > 1  # the lanes decode different things
    return t_out


def test_batch_decode_stateless_matches_jax(asr):
    jmodel, variables, tmodel = asr
    common = dict(vocab_size=8, sos=7, eos=7, beam_size=3, ctc_weight=0.3)
    _check_batch(JBeamSearch(jmodel, variables, **common), BatchBeamSearch(tmodel, **common),
                 _enc(16))


def test_cached_decoder_scorer_matches_jax(asr):
    """The standard decoder's per-beam KV cache: beam 4 against JAX's
    CachedDecoderScorer token for token (scores 1e-4), and under the
    lockstep batch."""
    jmodel, variables, tmodel = asr
    common = dict(vocab_size=8, sos=7, eos=7, beam_size=4, ctc_weight=0.3)
    j_bs = JBeamSearch(jmodel, variables, att_scorer=JCachedDecoder(jmodel, variables, 2, 1),
                       **common)
    t_bs = BatchBeamSearch(tmodel, att_scorer=CachedDecoderScorer(tmodel, 2, 1), **common)
    enc = _enc(16, seed=1)
    for b in range(3):
        n = int(ENC_LENS[b])
        _same(t_bs(torch.from_numpy(enc[b:b + 1, :n]), torch.tensor([n]), nbest=4),
              j_bs(jnp.asarray(enc[b:b + 1, :n]), jnp.asarray([n]), nbest=4))
    out = _check_batch(j_bs, t_bs, enc, maxlenratio=-6.0)
    assert any(len(h[0].yseq) > 3 for h in out)


def test_batch_decode_cached_guided_matches_jax():
    jcfg = jlg.LLMGuidedASRConfig(
        vocab_size=GV, llm=JLlamaConfig(**GUIDED["llm"]), prompt=JPromptTemplate(**GUIDED["prompt"]),
        frontend=JFrontendConfig(n_fft=256, hop_length=128, n_mels=23), normalize="utterance_mvn",
        encoder=JConformerConfig(**GUIDED["encoder"]), decoder=JDecConfig(**GUIDED["decoder"]),
        ctc_weight=0.3)
    jmodel = jlg.LLMGuidedASRModel(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
                                                jnp.asarray([4000]), jnp.ones((1, 3), jnp.int32),
                                                jnp.asarray([3])))
    variables = _fill(shapes, 4)
    tmodel = tlg.LLMGuidedASRModel(tlg.LLMGuidedASRConfig(
        vocab_size=GV, llm=LlamaConfig(**GUIDED["llm"]), prompt=PromptTemplate(**GUIDED["prompt"]),
        frontend=FrontendConfig(n_fft=256, hop_length=128, n_mels=23), normalize="utterance_mvn",
        encoder=ConformerConfig(**GUIDED["encoder"]),
        decoder=TransformerDecoderConfig(**GUIDED["decoder"]), ctc_weight=0.3),
        llm_dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    tmodel.eval()
    common = dict(vocab_size=GV, sos=7, eos=7, beam_size=4, ctc_weight=0.3)
    _check_batch(JBeamSearch(jmodel, variables, att_scorer=JCachedScorer(jmodel, variables),
                             **common),
                 BatchBeamSearch(tmodel, att_scorer=CachedGuidedScorer(tmodel), **common),
                 _enc(32, seed=2, scale=1.0), maxlenratio=-8.0)


def test_batch_call_matches_single_calls(asr):
    """Speech2Text.batch_call pads the batch to the longest request (rounded
    up to speech_pad_multiple), encodes once and decodes in lockstep; each
    request's result is what its own call gives.  (The lengths are chosen so
    that each request's own padding leaves the subsampled length unclamped:
    sub4_lengths rounds up and clamps to the padded width, as in JAX, so a
    request padded tightly alone can get fewer encoder frames than in a
    wider batch.)"""
    _, _, tmodel = asr
    rng = np.random.default_rng(12)
    waves = [rng.standard_normal(n).astype(np.float32) for n in (2600, 2048, 1000)]
    for kw in (dict(beam_size=3), dict(beam_size=3, use_cached_decoder=True)):
        s2t = Speech2Text.from_model(tmodel, ctc_weight=0.3, nbest=2, **kw)
        assert isinstance(s2t.beam.att_scorer, CachedDecoderScorer) == ("use_cached_decoder" in kw)
        for got, wave in zip(s2t.batch_call(waves), waves):
            want = s2t(wave)
            assert [ids for ids, _ in got] == [ids for ids, _ in want]
            np.testing.assert_allclose([h.score for _, h in got], [h.score for _, h in want],
                                       atol=1e-4)
    greedy = Speech2Text.from_model(tmodel, ctc_weight=1.0, beam_size=1)
    assert greedy.beam is None and greedy.batch_call(waves[:2]) == [greedy(w) for w in waves[:2]]


# ---------------------------------------------------------------------------
# the single-utterance CTC prefix functions as they stood before the lane
# axis (one utterance: logp [T, V], a scalar length, state rows [K])

class _State(NamedTuple):
    r: torch.Tensor
    psi: torch.Tensor
    last: torch.Tensor
    empty: torch.Tensor


def _old_psi(logp, length, state, cand, blank_id=0, eos_id=-1):
    t_max = logp.shape[0]
    valid = torch.arange(t_max) < length
    x = logp[:, cand].permute(1, 0, 2).masked_fill(~valid[None, :, None], tcp.NEG_INF)
    r_nb, r_b = state.r[..., 0], state.r[..., 1]
    r_sum = torch.logaddexp(r_nb, r_b)
    phi = torch.where((cand == state.last[:, None])[:, None, :], r_b[:, :, None], r_sum[:, :, None])
    psi_0 = torch.where(state.empty[:, None], x[:, 0, :], torch.full_like(x[:, 0, :], tcp.NEG_INF))
    psi = torch.logaddexp(psi_0, torch.logsumexp(phi[:, :-1, :] + x[:, 1:, :], dim=1))
    final_sum = r_sum[:, torch.clamp(torch.as_tensor(length) - 1, 0, t_max - 1)]
    if eos_id >= 0:
        psi = torch.where(cand == eos_id, final_sum[:, None].expand_as(psi), psi)
    return psi.masked_fill(cand == blank_id, tcp.NEG_INF)


def _old_advance(logp, length, state, token, parent, psi_new, blank_id=0):
    t_max, kp = logp.shape[0], token.shape[0]
    valid = torch.arange(t_max) < length
    r_prev = state.r[parent]
    x = logp[:, token].t().masked_fill(~valid[None, :], tcp.NEG_INF)
    xb = logp[:, blank_id].masked_fill(~valid, tcp.NEG_INF)
    r_b_prev, r_sum_prev = r_prev[..., 1], torch.logaddexp(r_prev[..., 0], r_prev[..., 1])
    phi = torch.where((token == state.last[parent])[:, None], r_b_prev, r_sum_prev)
    r_nb_0 = torch.where(state.empty[parent], x[:, 0], torch.full_like(x[:, 0], tcp.NEG_INF))
    r_b_0 = torch.full((kp,), tcp.NEG_INF)
    ca, cb = tcp._scan(x[:, 1:].t(), (phi[:, :-1] + x[:, 1:]).t())
    r_nb = torch.cat([r_nb_0[None], torch.logaddexp(r_nb_0[None] + ca, cb)], dim=0)
    xb_t = xb[1:, None].expand(t_max - 1, kp)
    ca, cb = tcp._scan(xb_t, r_nb[:-1] + xb_t)
    r_b = torch.cat([r_b_0[None], torch.logaddexp(r_b_0[None] + ca, cb)], dim=0)
    return _State(torch.stack([r_nb.t(), r_b.t()], dim=-1), psi_new, token.long(),
                  torch.zeros(kp, dtype=torch.bool))


@pytest.mark.parametrize("lanes", [1, 3])
def test_ctc_prefix_lanes_against_the_single_utterance_functions(lanes):
    """One lane: bitwise equal to the functions before the lane axis; three
    lanes of ragged lengths: each lane within 1e-5 of its own call."""
    rng = np.random.default_rng(lanes)
    for trial in range(6):
        t_max, v, k, w = (int(rng.integers(lo, hi)) for lo, hi in ((5, 60), (4, 40), (1, 11), (1, 9)))
        logp = torch.log_softmax(torch.from_numpy(
            rng.standard_normal((lanes, t_max, v)).astype(np.float32) * 3), -1)
        lens = torch.from_numpy(rng.integers(1, t_max + 1, lanes))
        new = tcp.ctc_prefix_init(logp, lens, k)
        old = [_State(*(f[b] for f in new)) for b in range(lanes)]
        for step in range(4):
            cand = torch.from_numpy(rng.integers(0, v, (lanes, k, w)))
            psi = tcp.ctc_prefix_psi(logp, lens, new, cand, eos_id=v - 1)
            ref = [_old_psi(logp[b], lens[b], old[b], cand[b], eos_id=v - 1) for b in range(lanes)]
            parent = torch.from_numpy(rng.integers(0, k, (lanes, k)))
            flat = parent * w + torch.from_numpy(rng.integers(0, w, (lanes, k)))
            token = torch.gather(cand.reshape(lanes, -1), 1, flat).clamp(min=1)
            sel = torch.gather(psi.reshape(lanes, -1), 1, flat)
            new = tcp.ctc_prefix_advance(logp, lens, new, token, parent, sel)
            old = [_old_advance(logp[b], lens[b], old[b], token[b], parent[b], sel[b])
                   for b in range(lanes)]
            for b in range(lanes):
                pairs = [(psi[b], ref[b])] + [(getattr(new, f)[b], getattr(old[b], f))
                                              for f in ("r", "psi", "last", "empty")]
                for got, want in pairs:
                    if lanes == 1:
                        assert torch.equal(got, want), (trial, step)
                    else:
                        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
