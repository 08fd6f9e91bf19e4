"""The port against the reference's golden fixtures (tests/parity/), on the CPU.

``golden_conformer.npz`` and ``golden_llm_guided.npz`` hold a tiny model's
reference (ESPnet) torch state dict as ``sd_*`` arrays, its inputs and the
reference's outputs.  The port loads the weights through its own
``models/espnet_ingest.py`` (held here array for array against the JAX
package's) and must reproduce the outputs at the tolerances of the JAX
package's parity tests (tests/test_parity_reference.py,
tests/test_parity_llm_guided.py); the checks themselves live in
``llm_guided_asr_tpu_torch/bin/golden_check.py``, which ``chip_smoke.py``
runs on the card.  The plain kernels run here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import espnet_ingest as jingest
from llm_guided_asr_tpu.models import llm_guided as jlg
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.llm.llama import convert_hf_state_dict as j_convert_hf
from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JTransformerDecoderConfig,
)
from llm_guided_asr_tpu_torch.bin import golden_check as gc
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import espnet_ingest as tingest
from llm_guided_asr_tpu_torch.models.llm.llama import load_safetensors

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def conformer():
    fx = gc.load_fixture("golden_conformer")
    return gc.build_conformer(fx, "cpu"), fx


@pytest.fixture(scope="module")
def guided():
    fx = gc.load_fixture("golden_llm_guided")
    return gc.build_guided(fx, "cpu"), fx


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = val
    return out


def _jax_tree(fx):
    """The variables the JAX package's parity tests build from the fixture."""
    meta, sd = fx.meta, fx.sd
    part = {p: {k[len(p) + 1:]: v for k, v in sd.items() if k.startswith(p + ".")}
            for p in ("enc", "dec", "ctc")}
    enc, enc_bs = jingest.conformer_encoder_params(
        part["enc"], num_blocks=meta["blocks"], input_size=meta["input_size"],
        odim=meta["odim"], macaron=True, use_cnn=True)
    params = {"encoder": enc, "ctc_head": jingest.ctc_head_params(part["ctc"], "ctc_lo")}
    if "embed.weight" in part["dec"]:
        params.update(jingest.llm_guided_decoder_params(part["dec"], meta["dec_blocks"]))
    else:
        params["decoder"] = jingest.transformer_decoder_params(part["dec"], meta["dec_blocks"])
    return {"params": params, "batch_stats": {"encoder": enc_bs}}


@pytest.mark.parametrize("name", ["golden_conformer", "golden_llm_guided"])
def test_ingest_matches_the_jax_ingest(name):
    """The port's name map and layouts, array for array, on every sd_ array
    (the (F', C) flatten permutation of the subsampling's output Linear
    included), and every array of the state dict but the batch norms'
    step counters (``num_batches_tracked``) lands in the tree."""
    fx = gc.load_fixture(name)
    got = _flat(tingest.params_from_reference(fx.sd, fx.meta))
    want = _flat(_jax_tree(fx))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    n_sd = sum(v.size for k, v in fx.sd.items() if not k.endswith("num_batches_tracked"))
    assert sum(v.size for v in got.values()) == n_sd  # nothing left behind


def test_encoder_matches_golden(conformer):
    gc.check_encoder(*conformer)


def test_long_utterance_encoder_matches_golden(conformer):
    gc.check_encoder(*conformer, long=True)


def test_ctc_and_decoder_match_golden(conformer):
    gc.check_ctc_and_decoder(*conformer)


@pytest.mark.parametrize("case", ["beam10", "beam1", "long"])
def test_beam_search_matches_golden(conformer, case):
    gc.check_beam(*conformer, case)


def test_beam_larger_than_vocab(conformer):
    gc.check_beam_over_vocab(*conformer)


def test_guided_training_loss_matches_golden(guided):
    gc.check_guided_loss(*guided)


def test_guided_teacher_forced_decoder_matches_golden(guided):
    gc.check_guided_decoder(*guided)


def test_guided_cached_steps_match_golden(guided):
    gc.check_guided_cached_steps(*guided)


def test_guided_beam10_matches_golden(guided):
    gc.check_guided_beam(*guided)


def _jax_guided(fx, first_pass_pad_frames):
    """The JAX package's LLM-guided model for the fixture, with the Llama
    converted from the same safetensors file, and its variables."""
    meta = fx.meta
    import json

    hf = json.loads((gc.LLM_DIR / "config.json").read_text())
    llm_cfg = JLlamaConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf["num_key_value_heads"], rms_norm_eps=hf["rms_norm_eps"],
        rope_theta=hf["rope_theta"], max_position_embeddings=hf["max_position_embeddings"])
    cfg = jlg.LLMGuidedASRConfig(
        vocab_size=meta["vocab"], llm=llm_cfg,
        prompt=JPromptTemplate(tuple(meta["template_prefix_ids"]),
                               tuple(meta["template_suffix_ids"]), meta["sos"], meta["eos"],
                               meta["pad_id"]),
        frontend=None, specaug=None, normalize="none",
        encoder=JConformerConfig(
            output_size=meta["odim"], attention_heads=meta["heads"], linear_units=meta["units"],
            num_blocks=meta["blocks"], dropout_rate=0.0, positional_dropout_rate=0.0,
            attention_dropout_rate=0.0, macaron_style=True, use_cnn_module=True,
            cnn_module_kernel=meta["kernel"], pad_safe_conv=False),
        decoder=JTransformerDecoderConfig(
            attention_heads=meta["heads"], linear_units=meta["units"],
            num_blocks=meta["dec_blocks"], dropout_rate=0.0, positional_dropout_rate=0.0),
        ctc_weight=meta["ctc_weight"], lsm_weight=meta["lsm_weight"],
        first_pass_pad_frames=first_pass_pad_frames)
    variables = _jax_tree(fx)
    llm = j_convert_hf(load_safetensors(gc.LLM_DIR / "model.safetensors"), llm_cfg)
    variables["params"]["llm"] = llm
    return jlg.LLMGuidedASRModel(cfg), variables


@pytest.mark.parametrize("first_pass_pad_frames", [True, False])
def test_first_pass_pad_frames_matches_jax(guided, first_pass_pad_frames):
    """On the ragged batch, where the first pass sees the shorter
    utterance's pad frames only with ``first_pass_pad_frames``: the loss
    and its parts as the JAX model computes them, features in (no
    frontend), with the flag on (the reference's behaviour) and off."""
    import dataclasses

    model, fx = guided
    a = fx.arrays
    tmodel = type(model)(dataclasses.replace(model.cfg, first_pass_pad_frames=first_pass_pad_frames),
                         llm_dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(model.state_dict())
    tmodel.eval()
    jmodel, variables = _jax_guided(fx, first_pass_pad_frames)
    jloss, jstats, _ = jax.jit(lambda v, *x: jmodel.apply(v, *x, deterministic=True))(
        variables, *(jnp.asarray(a[k]) for k in ("feats", "feats_lens", "text", "text_lens")))
    with torch.no_grad():
        loss, stats, _ = tmodel(*(torch.from_numpy(a[k]) for k in
                                  ("feats", "feats_lens", "text", "text_lens")))
    for name in ("loss_ctc", "loss_att", "acc"):
        np.testing.assert_allclose(float(stats[name]), float(jstats[name]), rtol=2e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-4)


def test_guided_llm_weights_match_the_jax_conversion(guided):
    """The guided model's LLM, loaded by load_llama_dir, holds what the JAX
    conversion of the same checkpoint gives through params_from_jax."""
    model, _ = guided
    jtree = j_convert_hf(load_safetensors(gc.LLM_DIR / "model.safetensors"),
                         JLlamaConfig(num_hidden_layers=model.cfg.llm.num_hidden_layers))
    want = params_from_jax({"params": {"llm": jtree}})
    got = model.state_dict()
    assert not [k for k in want if k != "llm.lm_head.weight" and k not in got]
    for key, val in want.items():
        if key != "llm.lm_head.weight":
            assert torch.equal(got[key], val), key


def test_first_pass_pad_frames_reads_the_pad_frames(guided):
    """The shorter utterance of the ragged batch: its first pass over every
    frame collapses a token out of the pad frames that the valid frames
    alone do not give (what the flag reproduces of the reference)."""
    import dataclasses

    model, fx = guided
    a = fx.arrays
    trimmed = type(model)(dataclasses.replace(model.cfg, first_pass_pad_frames=False),
                          llm_dtype=torch.float32, device="cpu")
    trimmed.load_state_dict(model.state_dict())
    with torch.no_grad():
        enc, lens = model.encode(torch.from_numpy(a["feats"]), torch.from_numpy(a["feats_lens"]))
        (_, every), (_, valid) = model._first_pass_hyp(enc, lens), trimmed._first_pass_hyp(enc, lens)
    short = int(torch.argmin(lens))
    assert lens[short] < enc.shape[1] and every[short] > valid[short]
    assert every[1 - short] == valid[1 - short]


# ---------------------------------------------------------------------------
# golden_trained_guided.npz: the reference-trained guided model on the tone corpus

def test_tone_corpus_matches_the_jax_tests_corpus(tmp_path):
    """The port's in-memory corpus equals the one tests/test_e2e_tiny.py
    writes and the JAX package reads back, sample for sample."""
    import sys

    sys.path.insert(0, str(gc.GOLD.parent))
    from test_e2e_tiny import make_corpus

    from llm_guided_asr_tpu.data.fileio import read_2columns_text, read_audio

    make_corpus(tmp_path, n_train=24, n_valid=6, seed=0)
    corpus = gc.make_tone_corpus(24, 6, 0)
    n = 0
    for split in ("train", "valid"):
        texts = read_2columns_text(tmp_path / split / "text")
        for uid, path in read_2columns_text(tmp_path / split / "wav.scp").items():
            wav, text = corpus[uid]
            assert text == texts[uid]
            np.testing.assert_array_equal(wav, read_audio(path)[1])
            n += 1
    assert n == len(corpus) == 30


def test_trained_guided_golden_decodes_and_cer():
    """All 30 utterances at beam 10, ctc_weight 0.3 through the cached
    guided scorer: the reference's hypotheses, scores within 5e-3, its CER."""
    fx = gc.load_fixture("golden_trained_guided")
    errs = gc.check_trained_guided(gc.build_trained_guided(fx, "cpu"), fx)
    assert errs["trained_guided_cer"] == pytest.approx(fx.meta["cer"], abs=1e-9)


@pytest.fixture(scope="module")
def trained():
    """The reference-trained CTC/attention model of golden_trained.npz and
    the tone corpus (tests/test_wer_parity_reference.py)."""
    fx = gc.load_fixture("golden_trained")
    c = fx.meta["corpus"]
    return gc.build_trained(fx, "cpu"), fx.meta, gc.make_tone_corpus(c["n_train"], c["n_valid"],
                                                                      c["seed"])


def test_trained_golden_offline_decodes_and_cer(trained):
    """All 30 utterances at beam 5, ctc_weight 0.3 with the stateless
    scorer: the reference's hypotheses, scores within 5e-3, its CER."""
    model, meta, corpus = trained
    errs = gc.check_trained(model, meta, meta, corpus, "trained")
    assert errs["trained_cer"] == pytest.approx(meta["cer"], abs=1e-9)


def test_trained_lm_golden_decodes_and_cer(trained):
    """Shallow fusion with the reference-trained TransformerLM at lm_weight
    0.3: the reference's hypotheses, scores within 5e-3, its CER."""
    model, meta, corpus = trained
    lm_meta = gc.json.loads((gc.GOLD / "golden_trained_lm.json").read_text())
    lm = gc.build_trained_lm(lm_meta, meta["vocab"], "cpu")
    errs = gc.check_trained(model, meta, lm_meta, corpus, "trained_lm", lm, lm_meta["lm_weight"])
    assert errs["trained_lm_cer"] == pytest.approx(lm_meta["cer"], abs=1e-9)


def test_trained_streamed_golden_hypotheses(trained):
    """The resumable search over 3 cuts of the first 8 utterances gives the
    offline golden hypotheses."""
    assert gc.check_trained_streaming(*trained) == 8


def test_lm_ingest_matches_the_jax_ingest():
    """The reference TransformerLM's lm_* arrays through both packages'
    name maps, array for array, every array used."""
    npz = np.load(gc.GOLD / "golden_trained_lm.npz")
    sd = {k[3:]: npz[k] for k in npz.files if k.startswith("lm_")}
    layers = gc.json.loads((gc.GOLD / "golden_trained_lm.json").read_text())["layer"]
    got = _flat(tingest.transformer_lm_params(sd, layers))
    want = _flat(jingest.transformer_lm_params(sd, layers))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert sum(v.size for v in got.values()) == sum(v.size for v in sd.values())


def test_transducer_golden_searches():
    """golden_transducer through golden_check.run_transducer: tsd, tsd3 and
    nsc, every entry of the 4-best lists (tokens equal, scores within
    1e-4), from the port's own ingest of the reference's LSTM weights."""
    errs = gc.run_transducer("cpu")
    assert set(errs) == {"transducer_tsd", "transducer_tsd3", "transducer_nsc"}
    assert max(errs.values()) <= gc.TRANSDUCER_SCORE_TOL


def test_transducer_ingest_matches_the_jax_ingest():
    """The reference's LSTM decoder and joint network through both packages'
    name maps, array for array."""
    sd = gc.load_fixture("golden_transducer").sd
    part = lambda prefix: {k[len(prefix):]: v for k, v in sd.items()  # noqa: E731
                           if k.startswith(prefix)}
    got = _flat(tingest.transducer_params(part("dec."), part("joint.")))
    want = _flat(jingest.transducer_params(part("dec."), part("joint.")))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
