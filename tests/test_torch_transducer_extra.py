"""Port vs JAX, the transducer searches of this slice: the reference's
golden_transducer results for tsd, tsd3 and nsc (all 4 n-best entries, on
the fixture's own LSTM weights); default, alsd, tsd, nsc and mbg against
the JAX searches on a seeded tiny LSTM model and on a stateless one (both
with two big blanks for mbg), from the same encoder rows; the multi-blank
greedy search on a scripted stub; and Speech2Text dispatching each
search."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import transducer as jtd
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.espnet_ingest import transducer_params as j_transducer_params
from llm_guided_asr_tpu.search import transducer_beam as jbeam
from llm_guided_asr_tpu.search import transducer_extra as jextra
from llm_guided_asr_tpu_torch.bin import golden_check
from llm_guided_asr_tpu_torch.bin.asr_inference import TRANSDUCER_SEARCHES, Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import transducer as ttd
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.search import transducer_beam as tbeam
from llm_guided_asr_tpu_torch.search import transducer_extra as textra
from test_torch_train import NO_DROP_ENC, _np
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

VOCAB, BEAM, T = 7, 4, 9
ENC = dict(output_size=8, attention_heads=2, linear_units=8, num_blocks=1, use_cnn_module=False,
           **NO_DROP_ENC)
DECODERS = {"rnn": dict(decoder_type="rnn", embed_size=6, hidden_size=8, num_layers=1),
            "stateless": dict(decoder_type="stateless", embed_size=8, hidden_size=8)}


@pytest.fixture(scope="module")
def golden():
    fx = golden_check.load_fixture("golden_transducer")
    return fx, golden_check.build_transducer(fx, "cpu")


@pytest.mark.parametrize("name", ["tsd", "tsd3", "nsc"])
def test_golden_searches_match_the_reference(golden, name):
    """All four n-best entries: the reference's tokens, scores within 1e-4;
    the fixture's weights reach the JAX ingest and the port's alike."""
    fx, model = golden
    meta, conf = fx.meta, fx.meta["configs"][name]
    dec_sd = {k[4:]: v for k, v in fx.sd.items() if k.startswith("dec.")}
    joint_sd = {k[6:]: v for k, v in fx.sd.items() if k.startswith("joint.")}
    want_params = params_from_jax({"params": j_transducer_params(dec_sd, joint_sd)})
    got_params = model.state_dict()
    for k, v in want_params.items():
        assert torch.equal(got_params[k], v), k
    enc, lens = torch.from_numpy(fx.arrays["enc_out"][None]), torch.tensor([meta["t"]])
    if conf["search_type"] == "tsd":
        hyps = textra.transducer_tsd_decode(model, enc, lens, beam_size=meta["beam"],
                                            max_sym_exp=conf["max_sym_exp"], nbest=meta["beam"])
    else:
        hyps = textra.transducer_nsc_decode(model, enc, lens, beam_size=meta["beam"],
                                            nstep=conf["nstep"],
                                            prefix_alpha=conf["prefix_alpha"], nbest=meta["beam"])
    want = meta["results"][name]
    assert [h.yseq for h in hyps] == [w["yseq"] for w in want]
    np.testing.assert_allclose([h.score for h in hyps], [w["score"] for w in want], rtol=0,
                               atol=1e-4)


_MODELS = {}


def _models(decoder_type):
    """(JAX model, variables, port model, encoder rows [1, T, 8] with 8
    valid frames): vocabulary 7 with big blanks 6 (2 frames) and 5 (3)."""
    if decoder_type not in _MODELS:
        common = dict(vocab_size=VOCAB, frontend=None, normalize="none", joint_size=8,
                      multi_blank_durations=(2, 3))
        jmodel = jtd.TransducerModel(jtd.TransducerModelConfig(
            encoder=JConformerConfig(**ENC),
            decoder=jtd.TransducerDecoderConfig(**DECODERS[decoder_type]), **common))
        variables = seeded_variables(jmodel, jnp.zeros((1, 16, 12)), jnp.asarray([16]),
                                     jnp.asarray([[1, 2]]), jnp.asarray([2]), seed=11)
        tmodel = ttd.TransducerModel(ttd.TransducerModelConfig(
            encoder=ConformerConfig(**ENC),
            decoder=ttd.TransducerDecoderConfig(**DECODERS[decoder_type]), input_size=12,
            **common), device="cpu")
        tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
        enc = (np.random.default_rng(3).standard_normal((1, T, 8)) * 2.0).astype(np.float32)
        _MODELS[decoder_type] = jmodel, variables, tmodel.eval(), enc
    return _MODELS[decoder_type]


SEARCHES = {  # name: (JAX search, port search, keyword arguments)
    "default": (jbeam.transducer_beam_decode, tbeam.transducer_beam_decode, {}),
    "alsd": (jbeam.transducer_alsd_decode, tbeam.transducer_alsd_decode, {"u_max": 6}),
    "tsd": (jextra.transducer_tsd_decode, textra.transducer_tsd_decode, {"max_sym_exp": 3}),
    "nsc": (jextra.transducer_nsc_decode, textra.transducer_nsc_decode,
            {"nstep": 2, "prefix_alpha": 2}),
}


@pytest.mark.parametrize("decoder_type", ["rnn", "stateless"])
@pytest.mark.parametrize("search", list(SEARCHES) + ["mbg"])
def test_search_matches_jax(decoder_type, search):
    """The whole n-best list (4 at beam 4): tokens equal, scores within
    1e-4; at least one hypothesis holds labels."""
    jmodel, variables, tmodel, enc = _models(decoder_type)
    lens = np.array([T - 1], np.int32)
    if search == "mbg":
        ids, durs = tmodel.cfg.big_blank_ids, tmodel.cfg.multi_blank_durations
        want = jextra.transducer_multiblank_greedy(jmodel, variables, jnp.asarray(enc),
                                                   jnp.asarray(lens), ids, durs)
        with torch.inference_mode():
            got = textra.transducer_multiblank_greedy(tmodel, torch.from_numpy(enc),
                                                      torch.from_numpy(lens), ids, durs)
    else:
        jfn, tfn, kw = SEARCHES[search]
        want = jfn(jmodel, variables, jnp.asarray(enc), jnp.asarray(lens), beam_size=BEAM,
                   nbest=BEAM, **kw)
        with torch.inference_mode():
            got = tfn(tmodel, torch.from_numpy(enc), torch.from_numpy(lens), beam_size=BEAM,
                      nbest=BEAM, **kw)
    assert [h.yseq for h in got] == [h.yseq for h in want]
    assert any(h.yseq for h in got)
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=0,
                               atol=1e-4)


class _StubCfg:
    blank_id = 0


class _StubModel:
    """A port copy of tests/test_transducer_extra.py's scripted model.

    vocab = [blank, 1, 2, 3, bigblank4 (dur 2)]; by frame: f0 emits 1 then
    blank, f1 a big blank (skipping f2), f2 would emit 2, f3 emits 3 then
    blank."""

    cfg = _StubCfg()

    def decode_labels(self, tokens):
        b, u = tokens.shape
        # g[u] = the number of labels consumed so far
        return torch.arange(u + 1, dtype=torch.float32)[None, :, None].expand(b, u + 1, 1)

    def joint_step(self, h, g):
        t, n = h[:, 0], g[:, 0]  # the frame, the total label count
        want_blank = ((t == 0) & (n >= 1)) | ((t == 2) & (n >= 6)) | ((t == 3) & (n >= 2))
        tok = torch.where(t == 0, 1, torch.where(t == 2, 2, torch.where(t == 3, 3, 0)))
        choose = torch.where(t == 1, 4, torch.where(want_blank, 0, tok))
        logits = torch.full((h.shape[0], 5), -1e3)
        logits[torch.arange(h.shape[0]), choose] = 0.0
        return logits


def test_multiblank_greedy_skips_frames():
    """A big blank ends its frame and skips its duration; without it
    registered, 4 is a label that frame 1 repeats up to the cap, and frame
    2's 2 appears."""
    enc = torch.arange(4, dtype=torch.float32)[None, :, None]
    hyps = textra.transducer_multiblank_greedy(_StubModel(), enc, torch.tensor([4]), (4,), (2,))
    assert hyps[0].yseq == [1, 3]
    hyps2 = textra.transducer_multiblank_greedy(_StubModel(), enc, torch.tensor([4]), (), ())
    assert 2 in hyps2[0].yseq and 4 in hyps2[0].yseq


def test_speech2text_dispatches_every_search():
    """Speech2Text on waveforms reaches every search of TRANSDUCER_SEARCHES
    with the model's own big blanks for mbg (at beam 1 too); an unknown
    name raises."""
    from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

    cfg = ttd.TransducerModelConfig(
        vocab_size=VOCAB, frontend=FrontendConfig(n_fft=128, hop_length=64, n_mels=20),
        normalize="utterance_mvn", encoder=ConformerConfig(**ENC),
        decoder=ttd.TransducerDecoderConfig(**DECODERS["rnn"]), joint_size=8,
        multi_blank_durations=(2,))
    torch.manual_seed(0)
    model = ttd.TransducerModel(cfg, device="cpu").eval()
    wave = np.random.default_rng(4).standard_normal(1500).astype(np.float32)
    with torch.inference_mode():
        enc, lens = model.encode(torch.from_numpy(np.pad(wave, (0, 100)))[None],
                                 torch.tensor([1500]))
        want = {"default": tbeam.transducer_beam_decode(model, enc, lens, beam_size=3),
                "alsd": tbeam.transducer_alsd_decode(model, enc, lens, beam_size=3),
                "tsd": textra.transducer_tsd_decode(model, enc, lens, beam_size=3),
                "nsc": textra.transducer_nsc_decode(model, enc, lens, beam_size=3),
                "mbg": textra.transducer_multiblank_greedy(model, enc, lens, (VOCAB - 1,), (2,))}
    assert set(TRANSDUCER_SEARCHES) == set(want)
    for search, hyps in want.items():
        for beam in ((3, 1) if search == "mbg" else (3,)):
            (ids, hyp), = Speech2Text.from_model(model, beam_size=beam,
                                                 transducer_search=search)(wave)
            assert hyp.yseq == hyps[0].yseq and hyp.score == pytest.approx(hyps[0].score)
    with pytest.raises(ValueError, match="maes"):
        Speech2Text.from_model(model, transducer_search="maes")
