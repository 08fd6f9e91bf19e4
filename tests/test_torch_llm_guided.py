"""Port vs JAX, the slice as a whole: a tiny LLM-guided model built from
LLMGuidedASRConfig in both packages with the same weights.  Encoder output,
teacher-forced decoder logits, cached decode steps (with beam reordering),
beam-3 searches and Speech2Text agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import llm_guided as jlg
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JDecoderConfig,
)
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.search.scorers import CachedGuidedScorer as JCachedScorer
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import llm_guided as tlg
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer

V = 50
SOS = EOS = 7
LLM = dict(vocab_size=V, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0,
           rope_scaling_factor=32.0, rope_original_max_position=64)
PROMPT = dict(prefix_ids=(2, 3, 4), suffix_ids=(5, 6), start_of_response_id=SOS,
              end_of_response_id=EOS, pad_id=0)
FRONTEND = dict(n_fft=256, hop_length=128, n_mels=23)
ENCODER = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
               macaron_style=True, cnn_module_kernel=7)
DECODER = dict(attention_heads=2, linear_units=64, num_blocks=2)
N_SAMPLES = 9000


def _j_encode(jmodel, variables, speech, lengths):
    return jax.jit(lambda s, n: jmodel.apply(variables, s, n, method=jmodel.encode))(
        jnp.asarray(speech), jnp.asarray(lengths))


@pytest.fixture(scope="module")
def models():
    jcfg = jlg.LLMGuidedASRConfig(
        vocab_size=V, llm=JLlamaConfig(**LLM), prompt=JPromptTemplate(**PROMPT),
        frontend=JFrontendConfig(**FRONTEND), normalize="utterance_mvn",
        encoder=JConformerConfig(**ENCODER), decoder=JDecoderConfig(**DECODER), ctc_weight=0.3,
    )
    jmodel = jlg.LLMGuidedASRModel(jcfg)
    rng = np.random.default_rng(0)
    speech = (rng.standard_normal((1, N_SAMPLES)) * 0.1).astype(np.float32)
    lengths = np.array([N_SAMPLES], np.int32)
    text = jnp.ones((1, 4), jnp.int32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(speech),
                                     jnp.asarray(lengths), text, jnp.array([4]))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 1.5, x.shape) if p[-1].key == "var"
                      else rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    variables = {**variables, "batch_stats": stats}

    tcfg = tlg.LLMGuidedASRConfig(
        vocab_size=V, llm=LlamaConfig(**LLM), prompt=PromptTemplate(**PROMPT),
        frontend=FrontendConfig(**FRONTEND), normalize="utterance_mvn",
        encoder=ConformerConfig(**ENCODER), decoder=TransformerDecoderConfig(**DECODER),
        ctc_weight=0.3,
    )
    tmodel = tlg.LLMGuidedASRModel(tcfg, llm_dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    tmodel.eval()
    j_enc, j_lens = _j_encode(jmodel, variables, speech, lengths)
    return jmodel, variables, tmodel, speech, j_enc, j_lens


def test_encode_matches_jax(models):
    jmodel, variables, tmodel, speech, j_enc, j_lens = models
    with torch.no_grad():
        t_enc, t_lens = tmodel.encode(torch.from_numpy(speech), torch.tensor([N_SAMPLES]))
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), rtol=1e-4, atol=1e-4)


def test_decoder_logits_match_jax(models):
    """The uncached teacher-forced forward: first pass, prompt pack with a
    ragged response batch, frozen LLM, guided decoder."""
    jmodel, variables, tmodel, _, j_enc, j_lens = models
    rng = np.random.default_rng(4)
    enc = np.concatenate([np.asarray(j_enc), np.asarray(j_enc)[:, ::-1]], axis=0)
    enc_lens = np.array([int(j_lens[0]), int(j_lens[0]) - 5], np.int32)
    ys = rng.integers(8, V, (2, 5)).astype(np.int32)
    ys[:, 0] = SOS
    ys_lens = np.array([5, 3], np.int32)
    j_logits = jax.jit(lambda *a: jmodel.apply(variables, *a, method=jmodel.decoder_logits))(
        *(jnp.asarray(x) for x in (enc, enc_lens, ys, ys_lens)))
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    with torch.no_grad():
        t_logits = tmodel.decoder_logits(T(enc), T(enc_lens).long(), T(ys).long(),
                                         T(ys_lens).long())
    for b, n in enumerate(ys_lens):  # valid response positions
        np.testing.assert_allclose(t_logits.numpy()[b, :n], np.asarray(j_logits)[b, :n],
                                   rtol=1e-3, atol=2e-4)


def test_cached_decode_steps_match_jax(models):
    jmodel, variables, tmodel, _, j_enc, j_lens = models
    K, LMAX = 3, 8
    j_sc = JCachedScorer(jmodel, variables)
    t_sc = CachedGuidedScorer(tmodel)
    enc = torch.from_numpy(np.array(j_enc))
    lens = torch.from_numpy(np.array(j_lens)).long()
    j_state = jax.jit(j_sc.init, static_argnums=(2, 3))(j_enc, j_lens[0], K, LMAX)
    j_step = jax.jit(j_sc.step)
    with torch.no_grad():
        t_state = t_sc.init(enc, lens[0], K, LMAX)
    tokens = np.full((K, LMAX), SOS, np.int32)
    tlen = np.ones(K, np.int32)
    chosen = [[4, 6, 9], [5, 8, 9], [4, 11, 2]]
    for step in range(4):
        j_logp, j_state = j_step(j_enc, j_lens[0], j_state, jnp.asarray(tokens),
                                 jnp.asarray(tlen), jnp.asarray(step))
        with torch.no_grad():
            t_logp, t_state = t_sc.step(enc, lens[0], t_state, torch.from_numpy(tokens).long(),
                                        torch.from_numpy(tlen).long(), step)
        np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), atol=2e-4, rtol=1e-3,
                                   err_msg=f"step {step}")
        if step == 3:
            break
        tokens[:, step + 1] = [chosen[b][step] for b in range(K)]
        tlen += 1
        parent = np.array([2, 0, 1]) if step == 1 else np.arange(K)
        tokens = tokens[parent]
        j_state = j_sc.select(j_state, jnp.asarray(parent))
        t_state = t_sc.select(t_state, torch.from_numpy(parent))


@pytest.mark.parametrize("ctc_weight,penalty", [(0.3, 0.0), (0.0, 0.5)])
def test_beam_search_matches_jax(models, ctc_weight, penalty):
    jmodel, variables, tmodel, _, j_enc, j_lens = models
    common = dict(vocab_size=V, sos=SOS, eos=EOS, beam_size=3, ctc_weight=ctc_weight,
                  penalty=penalty)
    j_bs = JBeamSearch(jmodel, variables, att_scorer=JCachedScorer(jmodel, variables), **common)
    t_bs = BatchBeamSearch(tmodel, att_scorer=CachedGuidedScorer(tmodel), **common)
    j_hyps = j_bs(j_enc, j_lens, nbest=3)
    t_hyps = t_bs(torch.from_numpy(np.array(j_enc)), torch.from_numpy(np.array(j_lens)).long(),
                  nbest=3)
    assert [h.yseq for h in t_hyps] == [h.yseq for h in j_hyps]
    for t, j in zip(t_hyps, j_hyps):
        np.testing.assert_allclose(t.score, j.score, atol=1e-3)
        assert t.scores.keys() == j.scores.keys()
        for key in j.scores:
            np.testing.assert_allclose(t.scores[key], j.scores[key], atol=1e-3)


def test_speech2text_matches_jax(models):
    """End to end from the waveform: Speech2Text pads to 1600-sample multiples."""
    jmodel, variables, tmodel, speech, _, _ = models
    j_bs = JBeamSearch(jmodel, variables, att_scorer=JCachedScorer(jmodel, variables),
                       vocab_size=V, sos=SOS, eos=EOS, beam_size=3, ctc_weight=0.3)
    padded = np.zeros((1, -(-N_SAMPLES // 1600) * 1600), np.float32)
    padded[:, :N_SAMPLES] = speech
    p_enc, p_lens = _j_encode(jmodel, variables, padded, np.array([N_SAMPLES], np.int32))
    j_best = j_bs(p_enc, p_lens, maxlenratio=-6.0)[0]
    (ids, t_best), = Speech2Text.from_model(tmodel, ctc_weight=0.3, beam_size=3,
                                            maxlenratio=-6.0)(speech[0])
    assert t_best.yseq == j_best.yseq
    assert ids == [i for i in j_best.yseq if i != SOS]
    np.testing.assert_allclose(t_best.score, j_best.score, atol=1e-3)


def test_model_requires_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tlg.LLMGuidedASRConfig(vocab_size=V, llm=LlamaConfig(**LLM),
                                 prompt=PromptTemplate(**PROMPT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlg.LLMGuidedASRModel(cfg)
