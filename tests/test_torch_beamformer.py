"""Port vs JAX, the multichannel frontend: ``wpe_dereverb``, ``psd_matrix``
and ``mvdr_beamform`` of ops/beamformer.py on complex64 inputs at C = 2
and 3 with 3 taps (1e-5 of the output's largest magnitude); the
``MultichannelFrontend`` features with and without WPE (1e-5 of the
largest feature); and a tiny multichannel CTC/attention ``ASRModel``
built by both packages' ``build_model`` from one task config, with and
without WPE: the stats at rtol 2e-4 and every gradient, the BiLSTM mask
estimator's included, at 1e-4 of its largest value plus 1e-6 of the
model's largest.  A gradient that misses that in float32 is settled in
float64 (JAX's model cloned to float64 under ``jax.enable_x64`` against
the port's model cast to float64, at the same tolerance, and the port's
float32 gradient within it of its float64 one).  Without WPE and the
beamformer a [B, S, C] batch is read at ``ref_channel``; the transducer
and the guided models refuse the multichannel fields, which the JAX
package ignores there."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.ops import beamformer as jbf
from llm_guided_asr_tpu.ops.frontend import MultichannelFrontend as JMultichannelFrontend
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.ops import beamformer as tbf
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig, MultichannelFrontend
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from test_torch_branchformer import _np
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

TOKENS = ["<blank>", "<unk>"] + list("abcdefghi") + ["<sos/eos>"]
FRONT = dict(n_fft=64, hop_length=16, n_mels=8, mask_units=8, wpe_taps=3, wpe_delay=2,
             wpe_iterations=2, ref_channel=1)
N_CH, N_SAMPLES = 3, 800


def _complex(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("channels", [2, 3])
def test_wpe_matches_jax(channels):
    y = _complex(np.random.default_rng(channels), (2, 5, channels, 40))
    want = jit(lambda a: jbf.wpe_dereverb(a, 3, 2, 2))(y)
    _close(tbf.wpe_dereverb(torch.from_numpy(y), 3, 2, 2).numpy(), want)


@pytest.mark.parametrize("channels", [2, 3])
def test_psd_and_mvdr_match_jax(channels):
    rng = np.random.default_rng(10 + channels)
    y = _complex(rng, (2, 5, channels, 40))
    m_s, m_n = (rng.uniform(size=(2, 5, 40)).astype(np.float32) for _ in range(2))
    ty, ts, tn = map(torch.from_numpy, (y, m_s, m_n))
    _close(tbf.psd_matrix(ty, ts).numpy(), jbf.psd_matrix(y, m_s))
    _close(tbf.mvdr_beamform(ty, ts, tn, 1).numpy(), jbf.mvdr_beamform(y, m_s, m_n, 1))


def test_stack_taps_delays_every_channel():
    y = torch.arange(1, 7, dtype=torch.float32).reshape(1, 6).to(torch.complex64)
    got = tbf._stack_taps(y[None], 2, 1)[0].real
    assert got.tolist() == [[0, 1, 2, 3, 4, 5], [0, 0, 1, 2, 3, 4]]


def _speech(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((2, N_SAMPLES, N_CH)) * 0.5).astype(np.float32),
            np.array([N_SAMPLES, 650], np.int32))


@pytest.mark.parametrize("wpe", [False, True])
def test_frontend_features_match_jax(wpe):
    jm = JMultichannelFrontend(use_wpe=wpe, use_beamformer=True, **FRONT)
    speech, lens = _speech()
    variables = seeded_variables(jm, jnp.asarray(speech), jnp.asarray(lens), seed=1)
    j_feats, j_lens = jit(jm.apply)(variables, speech, lens)
    tm = MultichannelFrontend(FrontendConfig(use_wpe=wpe, use_beamformer=True, **FRONT))
    tm.load_state_dict(params_from_jax(_np(variables)), strict=True)
    feats, flens = tm(*map(torch.from_numpy, (speech, lens)))
    _close(feats.detach().numpy(), j_feats)
    assert flens.tolist() == np.asarray(j_lens).tolist()


def config(wpe):
    return {**jasr.ASRTask.get_default_config(), "token_list": TOKENS,
            "normalize": "utterance_mvn", "encoder": "transformer",
            "frontend_conf": {**FRONT, "use_wpe": wpe, "use_beamformer": True},
            "encoder_conf": dict(output_size=16, attention_heads=2, linear_units=24,
                                 num_blocks=1, **NO_DROP_ENC),
            "decoder_conf": dict(attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_DEC),
            "model_conf": {"ctc_weight": 0.3}}


def _batch(seed=0):
    speech, lens = _speech(seed)
    text = np.array([[2, 3, 4, 5], [6, 7, -1, -1]], np.int32)
    return speech, lens, text, np.array([4, 2], np.int32)


def _torch(args):
    return tuple(torch.from_numpy(a) if a.dtype == np.float32 else torch.from_numpy(a).long()
                 for a in args)


@functools.lru_cache(maxsize=None)
def _models(wpe):
    cfg = config(wpe)
    jmodel = jasr.build_model(cfg)
    variables = seeded_variables(jmodel, *(jnp.asarray(a) for a in _batch()), seed=5)
    tmodel = tasr.build_model(cfg, "cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return jmodel, variables, tmodel


@functools.lru_cache(maxsize=None)
def _jax_grads(wpe, x64=False):
    """JAX's stats and gradients of batch 1 on the port's names; with
    ``x64`` the model and its variables in float64."""
    jmodel, variables, _ = _models(wpe)
    with jax.enable_x64(x64):
        if x64:
            jmodel = jmodel.clone(dtype=jnp.float64)
            variables = jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        args = [jnp.asarray(a.astype(np.float64) if x64 and a.dtype == np.float32 else a)
                for a in _batch(1)]

        def loss(params):
            (out, stats, _), _ = jmodel.apply({**variables, "params": params}, *args,
                                              deterministic=False, mutable=["batch_stats"])
            return out, stats

        (_, stats), grads = jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads)
    return ({k: float(v) for k, v in stats.items()},
            {n: g.numpy().astype(np.float64)
             for n, g in params_from_jax({"params": grads}).items()})


def _port_grads(model, double=False):
    m = copy.deepcopy(model).train()
    if double:
        m = m.double()
    args = tuple(a.double() if double and a.is_floating_point() else a
                 for a in _torch(_batch(1)))
    loss, stats, _ = m(*args)
    loss.backward()
    return ({k: float(v.detach()) for k, v in stats.items()},
            {n: p.grad.numpy().astype(np.float64) for n, p in m.named_parameters()})


@pytest.mark.parametrize("wpe", [False, True])
def test_multichannel_model_loss_and_gradients_match_jax(wpe):
    j_stats, want = _jax_grads(wpe)
    stats, got = _port_grads(_models(wpe)[2])
    assert stats.keys() == j_stats.keys()
    for k in stats:
        np.testing.assert_allclose(stats[k], j_stats[k], rtol=2e-4, err_msg=k)
    assert got.keys() == want.keys()
    assert any(n.startswith("mc_frontend.OptimizedLSTMCell_1.") for n in got)
    floor = 1e-6 * max(np.abs(r).max() for r in want.values())
    exact = None
    for name, g in got.items():
        tol = 1e-4 * np.abs(want[name]).max() + floor
        if np.abs(g - want[name]).max() > tol:
            exact = exact or (_jax_grads(wpe, True)[1], _port_grads(_models(wpe)[2], True)[1])
            assert np.abs(exact[1][name] - exact[0][name]).max() <= tol, name
            assert np.abs(g - exact[1][name]).max() <= tol, name


def test_reference_channel_alone_without_wpe_or_beamformer():
    """Neither on: no mask estimator, and a [B, S, C] batch gives the
    single-channel features of ``ref_channel``, as in JAX."""
    cfg = config(False)
    cfg["frontend_conf"] = {**cfg["frontend_conf"], "use_beamformer": False}
    model = tasr.build_model(cfg, "cpu")
    assert not hasattr(model, "mc_frontend")
    speech, lens = map(torch.from_numpy, _speech())
    got = model.collect_feats(speech, lens)["feats"]
    want = model.collect_feats(speech[..., FRONT["ref_channel"]].contiguous(), lens)["feats"]
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["transducer", "guided"])
@pytest.mark.parametrize("field", ["use_wpe", "use_beamformer"])
def test_other_models_refuse_the_multichannel_fields(model, field):
    from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRConfig, LLMGuidedASRModel
    from llm_guided_asr_tpu_torch.models.transducer import TransducerModel, TransducerModelConfig

    fe = FrontendConfig(**{field: True})
    with pytest.raises(ValueError, match="use_beamformer are read by the CTC/attention model"):
        if model == "transducer":
            TransducerModel(TransducerModelConfig(vocab_size=10, frontend=fe), device="cpu")
        else:
            LLMGuidedASRModel(LLMGuidedASRConfig(vocab_size=10, llm=None, prompt=None,
                                                 frontend=fe), device="cpu")


def test_speech2text_serves_a_multichannel_request():
    """A [S, C] request is padded along time to the bucket, every channel
    alike, and decoded (the JAX Speech2Text takes [S] alone)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text, encode_request

    model = copy.deepcopy(_models(False)[2]).eval()
    wave = _speech(3)[0][0, :700]
    padded = np.zeros((1600, N_CH), np.float32)
    padded[:700] = wave
    with torch.no_grad():
        got = encode_request(model, wave, 1600, torch.device("cpu"))
        want = model.encode(torch.from_numpy(padded[None]), torch.tensor([700]))
    assert torch.equal(got[0], want[0]) and got[1].tolist() == want[1].tolist()
    (ids, hyp), = Speech2Text.from_model(model, beam_size=2, maxlenratio=-3.0)(wave)
    assert np.isfinite(hyp.score) and all(0 <= i < len(TOKENS) for i in ids)


def test_batch_call_lanes_match_lone_multichannel_requests():
    """``batch_call`` pads [S, C] requests into one [B, n, C] batch; each
    lane's hypothesis equals the same request decoded alone (both pad to
    one 1600-sample bucket, so the encoder frames agree): tokens equal,
    scores within 1e-3 (the serve-batch rule)."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text

    model = copy.deepcopy(_models(True)[2]).eval()
    speech = _speech(4)[0]
    waves = [speech[0, :1500], speech[1, :900], speech[0, 200:1000]]
    s2t = Speech2Text.from_model(model, beam_size=3, maxlenratio=-3.0)
    batched = s2t.batch_call(waves)
    assert len(batched) == len(waves)
    for wave, ((ids, hyp),) in zip(waves, batched):
        (lone_ids, lone), = s2t(wave)
        assert ids == lone_ids
        assert abs(hyp.score - lone.score) <= 1e-3
    with pytest.raises(ValueError, match="channel shapes"):
        s2t.batch_call([waves[0], waves[1][:, :2]])
