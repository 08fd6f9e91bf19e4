"""Hold the port against the reference's golden fixtures, on the CPU or the card.

    python -m llm_guided_asr_tpu_torch.bin.golden_check [--device cuda|cpu]

The fixtures in ``tests/parity/`` were exported from the reference (ESPnet)
on torch CPU: a tiny random-weight model's torch state dict (the ``sd_*``
arrays), its inputs, and its outputs at several levels.  These are read here:

- ``golden_conformer.npz``: a CTC/attention model (Conformer 2 x 32, 2
  heads, kernel 7; transformer decoder 2 x 32; vocab 12): the encoder
  output and lengths (13 and 41 frames), the CTC and teacher-forced
  decoder log-probs, and the top beam-10, beam-1 and long-utterance
  hypotheses with their scores;
- ``golden_llm_guided.npz``: the LLM-guided model with the tiny Llama of
  ``tests/parity/tiny_llm_bpe/`` (loaded by ``load_llama_dir``): the
  equal-length training loss, the teacher-forced guided-decoder log-probs,
  every cached decoding step's log-probs, and the top beam-10 hypothesis;
- ``golden_trained_guided.npz``: an LLM-guided model the reference
  trained on the tone corpus (three characters, each a pure tone), with
  the tiny Llama frozen: the 30 utterances of the corpus are made again
  here from seed 0 (:func:`make_tone_corpus`, the int16 wav round trip
  included), the template ``fix "((HYP))" then reply: `` is split with the
  port's own reader of the BPE ``tokenizer.json``, and every utterance is
  decoded at beam 10, ctc_weight 0.3 through the cached guided scorer:
  hypotheses identical to the reference's, scores within 5e-3, and the
  corpus CER equal (tests/test_wer_parity_trained_guided.py:137-177);
- ``golden_trained.npz``: a plain CTC/attention model (vocab 6, Conformer
  2 x 32, kernel 7, utterance MVN, decoder 2 x 32) the reference trained
  on the same corpus, at the checkpoint's three operating points
  (tests/test_wer_parity_reference.py): offline beam 5, ctc_weight 0.3,
  the stateless scorer; shallow fusion with the reference-trained
  TransformerLM of ``golden_trained_lm.npz`` (embed 16, att 32, 2 heads,
  units 64, 2 layers, sinusoidal) at lm_weight 0.3 -- both with
  hypotheses identical, scores within 5e-3 and the CER within 1e-9 --
  and the resumable streaming search fed the offline encoder output of
  the first 8 utterances in 3 cuts, whose hypotheses must equal the
  offline ones;
- ``golden_transducer.npz``: the reference's LSTM prediction network
  (hidden 12, one layer) and joint network (joint 14, vocab 11) with an
  encoder output of 8 frames x 16: its time-synchronous searches
  (``tsd``: max_sym_exp 2, ``tsd3``: 3) and N-step constrained search
  (``nsc``: nstep 2, prefix_alpha 2) at beam 4, every entry of the 4-best
  list with identical tokens and a score within 1e-4 (the fixture's
  ``default`` and ``maes`` results are not the JAX package's searches,
  which the port follows).

Each check raises AssertionError on a miss, at the tolerances of the JAX
package's own parity tests (tests/test_parity_reference.py,
tests/test_parity_llm_guided.py), and returns what it measured.  The
weights go through ``models.espnet_ingest.params_from_reference`` and
``convert.params_from_jax``; both models run with ``pad_safe_conv=False``
(the reference convolves pad frames) and float32.  On the card the
encoder runs the hand-written ``rel_attention_fwd`` (head dim 16) and
``dwconv1d_fwd`` (K = 7) kernels, and the transducer's LSTM the
``lstm_fwd`` recurrence kernel.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.espnet_ingest import (
    params_from_reference,
    transducer_params,
    transformer_lm_params,
)
from llm_guided_asr_tpu_torch.models.lm import TransformerLM, TransformerLMConfig, make_lm_score_fn
from llm_guided_asr_tpu_torch.models.llm.llama import load_llama_dir
from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate, split_template
from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRConfig, LLMGuidedASRModel
from llm_guided_asr_tpu_torch.models.transducer import (
    TransducerDecoderConfig,
    TransducerModel,
    TransducerModelConfig,
)
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.losses import add_sos_eos
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer
from llm_guided_asr_tpu_torch.search.transducer_extra import (
    transducer_nsc_decode,
    transducer_tsd_decode,
)
from llm_guided_asr_tpu_torch.text.tokenizers import LLMTokenizer
from llm_guided_asr_tpu_torch.utils.metrics import error_rate

GOLD = Path(__file__).resolve().parents[2] / "tests" / "parity"
LLM_DIR = GOLD / "tiny_llm_bpe"


class Fixture(NamedTuple):
    arrays: Dict[str, np.ndarray]  # inputs and reference outputs
    meta: Dict
    sd: Dict[str, np.ndarray]  # the reference state dict (``sd_`` stripped)


def load_fixture(name: str) -> Fixture:
    npz = np.load(GOLD / f"{name}.npz")
    meta = json.loads((GOLD / f"{name}.json").read_text())
    arrays = {k: npz[k] for k in npz.files if not k.startswith("sd_")}
    sd = {k[3:]: npz[k] for k in npz.files if k.startswith("sd_")}
    return Fixture(arrays, meta, sd)


def _encoder_cfg(meta) -> ConformerConfig:
    return ConformerConfig(
        output_size=meta["odim"], attention_heads=meta["heads"], linear_units=meta["units"],
        num_blocks=meta["blocks"], dropout_rate=0.0, positional_dropout_rate=0.0,
        attention_dropout_rate=0.0, macaron_style=True, use_cnn_module=True,
        cnn_module_kernel=meta["kernel"],
        pad_safe_conv=False,  # the reference convolves pad frames
    )


def _decoder_cfg(meta) -> TransformerDecoderConfig:
    return TransformerDecoderConfig(
        attention_heads=meta["heads"], linear_units=meta["units"],
        num_blocks=meta["dec_blocks"], dropout_rate=0.0, positional_dropout_rate=0.0,
    )


def build_conformer(fx: Fixture, device) -> ASRModel:
    """The CTC/attention model with the fixture's weights, in eval mode.
    Its encoder takes the fixture's features ([B, T, input_size]) directly,
    so the frontend is configured only for that width and never runs."""
    meta = fx.meta
    cfg = ASRModelConfig(
        vocab_size=meta["vocab"], frontend=FrontendConfig(n_mels=meta["input_size"]),
        normalize="none", encoder=_encoder_cfg(meta), decoder=_decoder_cfg(meta),
        ctc_weight=meta["ctc_weight"],
    )
    model = ASRModel(cfg, device=device)
    model.load_state_dict(params_from_jax(params_from_reference(fx.sd, meta)))
    return model.eval()


def build_guided(fx: Fixture, device) -> LLMGuidedASRModel:
    """The LLM-guided model with the fixture's weights and the tiny Llama,
    float32, eval mode; it takes features (no frontend) and runs the first
    pass over every frame (``first_pass_pad_frames``), as the reference's
    training does.  The prompt is built from the fixture's token ids, so no
    tokenizer is needed."""
    meta = fx.meta
    llm_cfg, llm_sd = load_llama_dir(LLM_DIR)
    template = PromptTemplate(
        prefix_ids=tuple(meta["template_prefix_ids"]),
        suffix_ids=tuple(meta["template_suffix_ids"]),
        start_of_response_id=meta["sos"], end_of_response_id=meta["eos"],
        pad_id=meta["pad_id"],
    )
    cfg = LLMGuidedASRConfig(
        vocab_size=meta["vocab"], llm=llm_cfg, prompt=template, frontend=None,
        input_size=meta["input_size"], specaug=None, normalize="none",
        encoder=_encoder_cfg(meta), decoder=_decoder_cfg(meta),
        ctc_weight=meta["ctc_weight"], lsm_weight=meta["lsm_weight"],
        first_pass_pad_frames=True,
    )
    model = LLMGuidedASRModel(cfg, llm_dtype=torch.float32, device=device)
    sd = params_from_jax(params_from_reference(fx.sd, meta))
    sd.update({f"llm.{k}": v for k, v in llm_sd.items() if k != "lm_head.weight"})
    model.load_state_dict(sd)
    return model.eval()


def _on(model, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(next(model.parameters()).device)


def _close(got: torch.Tensor, want: np.ndarray, rtol: float, atol: float, what: str) -> float:
    got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return float(np.abs(got - want).max()) if want.size else 0.0


def _strip(seq, sos: int, eos: int) -> list:
    seq = list(seq)
    if seq and seq[0] == sos:
        seq = seq[1:]
    if seq and seq[-1] == eos:
        seq = seq[:-1]
    return seq


def _top_hypothesis(bs: BatchBeamSearch, model, enc: np.ndarray, enc_len: int, meta,
                    ref_tokens, ref_score: float, atol: float, what: str, nbest: int = 1):
    """The top hypothesis of ``bs`` over one utterance: its tokens equal to
    the reference's (sos and eos stripped), its score within ``atol``."""
    with torch.no_grad():
        hyps = bs(_on(model, enc[None, :enc_len]), _on(model, [enc_len]), maxlenratio=0.0,
                  nbest=nbest)
    got = _strip(hyps[0].yseq, meta["sos"], meta["eos"])
    want = _strip(ref_tokens, meta["sos"], meta["eos"])
    assert got == want, f"{what}: tokens {got}, reference {want}"
    err = abs(hyps[0].score - ref_score)
    assert err <= atol, f"{what}: score {hyps[0].score}, reference {ref_score} (atol {atol})"
    return err


# ---------------------------------------------------------------------------
# golden_conformer.npz (tests/test_parity_reference.py)
# ---------------------------------------------------------------------------

def check_encoder(model: ASRModel, fx: Fixture, long: bool = False) -> Dict[str, float]:
    """Encoder output on the valid frames at rtol = atol = 1e-4 and the
    output lengths exactly; ``long``: the 3x longer utterance, and its CTC
    log-probs at 1e-4."""
    a = fx.arrays
    feats, lens, ref, ref_lens = (("feats_long", "feats_long_lens", "enc_out_long", "enc_long_lens")
                                  if long else ("feats", "feats_lens", "enc_out", "enc_lens"))
    with torch.no_grad():
        out, out_lens = model.encoder(_on(model, a[feats]), _on(model, a[lens]))
    np.testing.assert_array_equal(out_lens.cpu().numpy(), a[ref_lens])
    tag = "enc_out_long" if long else "enc_out"
    errs = {tag: max(_close(out[b, :n], a[ref][b, :n], 1e-4, 1e-4, f"{tag} utt {b}")
                     for b, n in enumerate(a[ref_lens]))}
    if long:
        n = int(a["enc_long_lens"][0])
        with torch.no_grad():
            logp = model.ctc_log_softmax(_on(model, a["enc_out_long"]))
        errs["ctc_logp_long"] = _close(logp[0, :n], a["ctc_logp_long"][0, :n], 1e-4, 1e-4,
                                       "ctc_logp_long")
    return errs


def check_ctc_and_decoder(model: ASRModel, fx: Fixture) -> Dict[str, float]:
    """CTC and teacher-forced decoder log-probs from the reference encoder
    output, on the valid rows, at rtol = atol = 1e-4."""
    a = fx.arrays
    enc, enc_lens = _on(model, a["enc_out"]), _on(model, a["enc_lens"])
    with torch.no_grad():
        ctc = model.ctc_log_softmax(enc)
        logits = model.decoder_logits(enc, enc_lens, _on(model, a["ys_in"]),
                                      _on(model, a["ys_in_lens"]))
    dec = F.log_softmax(logits.float(), dim=-1)
    return {
        "ctc_logp": max(_close(ctc[b, :n], a["ctc_logp"][b, :n], 1e-4, 1e-4, f"ctc utt {b}")
                        for b, n in enumerate(a["enc_lens"])),
        "dec_logp": max(_close(dec[b, :n], a["dec_logp"][b, :n], 1e-4, 1e-4, f"decoder utt {b}")
                        for b, n in enumerate(a["ys_in_lens"])),
    }


def check_beam(model: ASRModel, fx: Fixture, case: str) -> float:
    """The joint CTC/attention beam search (ctc_weight 0.3) against the
    reference's top hypothesis: ``beam10`` (score atol 2e-3), ``beam1``
    (atol 700: the width-1 pre-beam admits only the top decoder token, the
    path goes through the blank, and the reference's own score is float32
    logzero-cancellation noise, +-1e10 deltas telescoping at ~1e3
    resolution) and ``long`` (beam 10 on the 41-frame utterance, atol
    5e-3)."""
    a, m = fx.arrays, fx.meta
    beam, suffix, atol, enc, lens = {
        "beam10": (m["beam"], "", 2e-3, "enc_out", "enc_lens"),
        "beam1": (1, "_beam1", 700.0, "enc_out", "enc_lens"),
        "long": (m["beam"], "_long", 5e-3, "enc_out_long", "enc_long_lens"),
    }[case]
    bs = BatchBeamSearch(model, vocab_size=m["vocab"], sos=m["sos"], eos=m["eos"],
                         beam_size=beam, ctc_weight=m["ctc_weight"])
    return _top_hypothesis(bs, model, a[enc][0], int(a[lens][0]), m, m["hyp_tokens" + suffix][0],
                           m["hyp_scores" + suffix][0], atol, case, nbest=3)


def check_beam_over_vocab(model: ASRModel, fx: Fixture) -> float:
    """beam > vocab: K clamps to the vocabulary (the reference crashes
    there), and every hypothesis keeps its true score: <= 0, above -100,
    and 0.7 * decoder + 0.3 * ctc to 1e-3."""
    a, m = fx.arrays, fx.meta
    bs = BatchBeamSearch(model, vocab_size=m["vocab"], sos=m["sos"], eos=m["eos"],
                         beam_size=m["vocab"] + 8, ctc_weight=m["ctc_weight"])
    assert bs.K == m["vocab"], bs.K
    n = int(a["enc_lens"][0])
    with torch.no_grad():
        hyps = bs(_on(model, a["enc_out"][:1, :n]), _on(model, a["enc_lens"][:1]),
                  maxlenratio=0.0, nbest=5)
    worst = 0.0
    for h in hyps:
        assert -100.0 < h.score <= 0.0, f"score {h.score} for {h.yseq}"
        total = 0.7 * h.scores["decoder"] + 0.3 * h.scores["ctc"]
        assert abs(h.score - total) <= 1e-3, (h.score, total)
        worst = max(worst, abs(h.score - total))
    return worst


# ---------------------------------------------------------------------------
# golden_llm_guided.npz (tests/test_parity_llm_guided.py)
# ---------------------------------------------------------------------------

def check_guided_loss(model: LLMGuidedASRModel, fx: Fixture) -> Dict[str, float]:
    """The training loss on the equal-length batch (every frame valid, so
    the first pass sees no pad frame): loss, loss_ctc and loss_att at rtol
    2e-4, acc at atol 1e-6."""
    a, m = fx.arrays, fx.meta
    feats = _on(model, a["feats"])
    lens = torch.full_like(_on(model, a["feats_lens"]), feats.shape[1])
    with torch.no_grad():
        loss, stats, _ = model(feats, lens, _on(model, a["text"]), _on(model, a["text_lens"]))
    errs = {}
    for name, got, rtol, atol in (("loss_ctc", stats["loss_ctc"], 2e-4, 0.0),
                                  ("loss_att", stats["loss_att"], 2e-4, 0.0),
                                  ("loss", loss, 2e-4, 0.0), ("acc", stats["acc"], 0.0, 1e-6)):
        want = np.float64(m[f"{name}_eq"])
        errs[name] = _close(got.reshape(1), np.array([want]), rtol, atol, name)
    return errs


def check_guided_decoder(model: LLMGuidedASRModel, fx: Fixture) -> float:
    """Teacher-forced guided-decoder log-probs from the reference encoder
    output at rtol 1e-3, atol 2e-4 on the valid rows."""
    a, m = fx.arrays, fx.meta
    text, text_lens = _on(model, a["text"]), _on(model, a["text_lens"])
    ys_in, _ = add_sos_eos(text, text_lens, m["sos"], m["eos"], -1)
    with torch.no_grad():
        logits = model.decoder_logits(_on(model, a["enc_out"]), _on(model, a["enc_lens"]),
                                      ys_in, text_lens + 1)
    logp = F.log_softmax(logits.float(), dim=-1)
    return max(_close(logp[b, :n], a["dec_logp"][b, :n], 1e-3, 2e-4, f"guided decoder utt {b}")
               for b, n in enumerate(a["text_lens"] + 1))


def check_guided_cached_steps(model: LLMGuidedASRModel, fx: Fixture) -> float:
    """Every cached decoding step's log-probs at rtol 1e-3, atol 3e-4: step
    0 the root hypothesis, then two beams forced along ``forced_tokens``,
    sharing the prompt's KV."""
    a, m = fx.arrays, fx.meta
    n = int(a["enc_lens"][0])
    enc, enc_len = _on(model, a["enc_out"][:1, :n]), _on(model, a["enc_lens"][0])
    forced = a["forced_tokens"]  # [steps, 2 beams]
    beams, lmax = 2, 8
    scorer = CachedGuidedScorer(model)
    dev = enc.device
    worst = 0.0
    with torch.no_grad():
        state = scorer.init(enc, enc_len, beams, lmax)
        tokens = torch.full((beams, lmax), m["sos"], dtype=torch.int64, device=dev)
        lens = torch.ones(beams, dtype=torch.int64, device=dev)
        for step in range(int(m["n_steps"])):
            logp, state = scorer.step(enc, enc_len, state, tokens, lens, step)
            ref = a[f"step_logp_{step}"]
            worst = max(worst, _close(logp[: ref.shape[0]], ref, 1e-3, 3e-4, f"cached step {step}"))
            if step < forced.shape[0]:
                tokens[:, step + 1] = torch.as_tensor(forced[step], device=dev)
                lens = lens + 1
    return worst


def check_guided_beam(model: LLMGuidedASRModel, fx: Fixture) -> float:
    """Beam 10, ctc_weight 0.3, with the cached guided scorer: the top
    hypothesis token for token, its score at atol 3e-3."""
    a, m = fx.arrays, fx.meta
    bs = BatchBeamSearch(model, vocab_size=m["vocab"], sos=m["sos"], eos=m["eos"],
                         beam_size=m["beam"], ctc_weight=m["ctc_weight"],
                         att_scorer=CachedGuidedScorer(model))
    return _top_hypothesis(bs, model, a["enc_out"][0], int(a["enc_lens"][0]), m,
                           m["hyp_tokens"][0], m["hyp_scores"][0], 3e-3, "guided beam10",
                           nbest=3)


# ---------------------------------------------------------------------------
# golden_trained_guided.npz (tests/test_wer_parity_trained_guided.py)
# ---------------------------------------------------------------------------

SR = 16000
TONES = {"a": 400.0, "b": 900.0, "c": 1900.0}  # tests/test_e2e_tiny.py


def _synth(text: str, rng: np.random.Generator) -> np.ndarray:
    """50 ms of silence, then each character's 150 ms tone and 50 ms of
    silence; noise of standard deviation 0.01 over all of it."""
    chunks = [np.zeros(int(0.05 * SR), np.float32)]
    for ch in text:
        t = np.arange(int(0.15 * SR)) / SR
        chunks.append(0.5 * np.sin(2 * np.pi * TONES[ch] * t).astype(np.float32))
        chunks.append(np.zeros(int(0.05 * SR), np.float32))
    wav = np.concatenate(chunks)
    return wav + 0.01 * rng.standard_normal(len(wav)).astype(np.float32)


def _wav_round_trip(wav: np.ndarray) -> np.ndarray:
    """What a 16-bit wav file written and read back holds: clipped, scaled
    by 32767 and truncated to int16 on the way out, divided by 32768 on
    the way in."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return pcm.astype(np.float32) / 32768.0


def make_tone_corpus(n_train: int = 24, n_valid: int = 6, seed: int = 0) -> Dict[str, tuple]:
    """{uid: (waveform, text)} of the tone corpus, drawn in the order of
    tests/test_e2e_tiny.py make_corpus: per utterance its length (2-5
    characters), its characters, then its noise."""
    rng = np.random.default_rng(seed)
    chars = list(TONES)
    out = {}
    for split, n in (("train", n_train), ("valid", n_valid)):
        for i in range(n):
            text = "".join(rng.choice(chars) for _ in range(rng.integers(2, 6)))
            out[f"{split}_{i:03d}"] = (_wav_round_trip(_synth(text, rng)), text)
    return out


def build_trained_guided(fx: Fixture, device) -> LLMGuidedASRModel:
    """The reference-trained guided model: the fixture's encoder, CTC head
    and guided decoder, the tiny Llama, the template split by the port's
    tokenizer with pad token ``<unk>``; frontend (n_fft 256, hop 128, 23
    mels) and utterance MVN, float32, eval mode."""
    meta = fx.meta
    llm_cfg, llm_sd = load_llama_dir(LLM_DIR)
    hf = json.loads((LLM_DIR / "config.json").read_text())
    template = split_template(LLMTokenizer.from_pretrained(LLM_DIR), meta["template"],
                              bos_token_id=hf["bos_token_id"], eos_token_id=hf["eos_token_id"],
                              pad_token="<unk>")
    assert (template.start_of_response_id, template.end_of_response_id) == (meta["sos"], meta["eos"])
    cfg = LLMGuidedASRConfig(
        vocab_size=meta["vocab"], llm=llm_cfg, prompt=template,
        frontend=FrontendConfig(n_fft=meta["n_fft"], hop_length=meta["hop"],
                                n_mels=meta["n_mels"]),
        normalize="utterance_mvn", encoder=_encoder_cfg(meta), decoder=_decoder_cfg(meta),
        ctc_weight=meta["ctc_weight_decode"],
    )
    model = LLMGuidedASRModel(cfg, llm_dtype=torch.float32, device=device)
    sd = params_from_jax(params_from_reference(fx.sd, {**meta, "input_size": meta["n_mels"]}))
    sd.update({f"llm.{k}": v for k, v in llm_sd.items() if k != "lm_head.weight"})
    model.load_state_dict(sd)
    return model.eval()


def check_trained_guided(model: LLMGuidedASRModel, fx: Fixture) -> Dict[str, float]:
    """Every utterance of the tone corpus decoded from its waveform (beam
    10, ctc_weight 0.3, maxlenratio 0, the cached guided scorer): the
    hypothesis equal to the reference's, its score within 5e-3, and the
    corpus CER (characters as LLM ids) equal to the reference's within
    1e-9.  Returns the largest score error and the CER."""
    m = fx.meta
    tok = LLMTokenizer.from_pretrained(LLM_DIR)
    bs = BatchBeamSearch(model, vocab_size=m["vocab"], sos=m["sos"], eos=m["eos"],
                         beam_size=m["beam"], ctc_weight=m["ctc_weight_decode"],
                         att_scorer=CachedGuidedScorer(model))
    corpus = make_tone_corpus(m["corpus"]["n_train"], m["corpus"]["n_valid"], m["corpus"]["seed"])
    worst, mismatches, refs, hyps = 0.0, [], [], []
    for uid in sorted(corpus):
        wav, text = corpus[uid]
        with torch.no_grad():
            enc, enc_lens = model.encode(_on(model, wav[None]), _on(model, [len(wav)]))
        best = bs(enc, enc_lens, maxlenratio=0.0, nbest=1)[0]
        inner = [t for t in best.yseq if t not in (m["sos"], m["eos"])]
        if inner != m["hyps"][uid]:
            mismatches.append((uid, inner, m["hyps"][uid]))
        else:
            err = abs(best.score - m["scores"][uid])
            assert err <= 5e-3, f"trained guided {uid}: score {best.score}, reference {m['scores'][uid]}"
            worst = max(worst, err)
        refs.append(tok.convert_tokens_to_ids(list(text)))
        hyps.append(inner)
    assert not mismatches, f"trained guided: {len(mismatches)} hypotheses differ, e.g. {mismatches[:3]}"
    cer = error_rate(refs, hyps)["err"]
    assert abs(cer - m["cer"]) <= 1e-9, f"trained guided CER {cer}, reference {m['cer']}"
    return {"trained_guided_score": worst, "trained_guided_cer": cer}


# ---------------------------------------------------------------------------
# golden_trained.npz, golden_trained_lm.npz (tests/test_wer_parity_reference.py)
# ---------------------------------------------------------------------------

TONE_TOKENS = ["<blank>", "<unk>", "a", "b", "c", "<sos/eos>"]  # tests/test_e2e_tiny.py
N_STREAMED = 8  # utterances of the streamed check, as the JAX test takes


def build_trained(fx: Fixture, device) -> ASRModel:
    """The reference-trained CTC/attention model: frontend (n_fft 256, hop
    128, 23 mels), utterance MVN, the fixture's encoder, decoder and CTC
    head, float32, eval mode."""
    meta = fx.meta
    cfg = ASRModelConfig(
        vocab_size=meta["vocab"],
        frontend=FrontendConfig(n_fft=meta["n_fft"], hop_length=meta["hop"],
                                n_mels=meta["n_mels"]),
        normalize="utterance_mvn", encoder=_encoder_cfg(meta), decoder=_decoder_cfg(meta),
        ctc_weight=meta["ctc_weight_decode"],
    )
    model = ASRModel(cfg, device=device)
    model.load_state_dict(params_from_jax(
        params_from_reference(fx.sd, {**meta, "input_size": meta["n_mels"]})))
    return model.eval()


def build_trained_lm(lm_meta: Dict, vocab: int, device) -> TransformerLM:
    """The reference-trained TransformerLM of ``golden_trained_lm.npz``."""
    npz = np.load(GOLD / "golden_trained_lm.npz")
    sd = {k[3:]: npz[k] for k in npz.files if k.startswith("lm_")}
    cfg = TransformerLMConfig(vocab_size=vocab, pos_enc="sinusoidal",
                              embed_unit=lm_meta["embed_unit"], att_unit=lm_meta["att_unit"],
                              head=lm_meta["head"], unit=lm_meta["unit"], layer=lm_meta["layer"],
                              dropout_rate=0.0)
    lm = TransformerLM(cfg, device=device)
    lm.load_state_dict(params_from_jax({"params": transformer_lm_params(sd, cfg.layer)}))
    return lm.eval()


def trained_search(model: ASRModel, meta: Dict, lm=None, lm_weight: float = 0.0
                   ) -> BatchBeamSearch:
    return BatchBeamSearch(model, vocab_size=meta["vocab"], sos=meta["sos"], eos=meta["eos"],
                           beam_size=meta["beam"], ctc_weight=meta["ctc_weight_decode"],
                           lm_score_fn=None if lm is None else make_lm_score_fn(lm),
                           lm_weight=lm_weight)


def check_trained(model: ASRModel, meta: Dict, want: Dict, corpus: Dict, tag: str,
                  lm=None, lm_weight: float = 0.0) -> Dict[str, float]:
    """Every utterance of the tone corpus decoded from its waveform (beam
    5, ctc_weight 0.3, maxlenratio 0, the stateless scorer; with ``lm``
    shallow fusion at ``lm_weight``): the hypotheses of ``want`` token for
    token, scores within 5e-3, the corpus CER within 1e-9."""
    bs = trained_search(model, meta, lm, lm_weight)
    worst, mismatches, refs, hyps = 0.0, [], [], []
    for uid in sorted(corpus):
        wav, text = corpus[uid]
        with torch.no_grad():
            enc, enc_lens = model.encode(_on(model, wav[None]), _on(model, [len(wav)]))
        best = bs(enc, enc_lens, maxlenratio=0.0, nbest=1)[0]
        inner = [t for t in best.yseq if t not in (meta["sos"], meta["eos"])]
        if inner != want["hyps"][uid]:
            mismatches.append((uid, inner, want["hyps"][uid]))
        else:
            err = abs(best.score - want["scores"][uid])
            assert err <= 5e-3, f"{tag} {uid}: score {best.score}, reference {want['scores'][uid]}"
            worst = max(worst, err)
        refs.append([TONE_TOKENS.index(c) for c in text])
        hyps.append(inner)
    assert not mismatches, f"{tag}: {len(mismatches)} hypotheses differ, e.g. {mismatches[:3]}"
    cer = error_rate(refs, hyps)["err"]
    assert abs(cer - want["cer"]) <= 1e-9, f"{tag} CER {cer}, reference {want['cer']}"
    return {f"{tag}_score": worst, f"{tag}_cer": cer}


def check_trained_streaming(model: ASRModel, meta: Dict, corpus: Dict) -> int:
    """The resumable search over the first 8 utterances: each one's offline
    encoder output fed in 3 cuts (t/3, 2t/3, t), the buffers at full width
    with the rows past the cut zeroed; between cuts the token budget is the
    CTC-greedy count over the frames of the previous cut (the trusted
    region), at the last cut the valid frames.  The hypotheses must equal
    the offline golden ones (tests/test_wer_parity_reference.py:221-295).
    Returns the number of utterances checked."""
    bs = trained_search(model, meta)
    mismatches = []
    uids = sorted(corpus)[:N_STREAMED]
    for uid in uids:
        wav, _ = corpus[uid]
        with torch.no_grad():
            enc, enc_lens = model.encode(_on(model, wav[None]), _on(model, [len(wav)]))
            ctc_logp = model.ctc_log_softmax(enc)[0]  # [T, V]
        t, width = int(enc_lens[0]), enc.shape[1]
        rows = torch.arange(width, device=enc.device)
        cuts = [max(t // 3, 1), max(2 * t // 3, 2), t]
        carry, prev = None, 0
        for ci, cut in enumerate(cuts):
            enc_buf = enc.masked_fill(~(rows < cut)[None, :, None], 0.0)
            ctc_buf = ctc_logp.masked_fill(~(rows < cut)[:, None], 0.0)
            if carry is None:
                carry, prev = bs.stream_start(ctc_buf, enc_buf, cut, width), cut
                continue
            if ci == len(cuts) - 1:
                maxlen = cut
            else:
                am = ctc_logp[:prev].argmax(-1).cpu().numpy()
                col = am[np.concatenate([[True], am[1:] != am[:-1]])] if prev else np.zeros(0)
                maxlen = min(int((col != bs.blank_id).sum()), cut)
            carry = bs.stream_step(enc_buf, prev, cut, maxlen, 0, carry, ctc_buf)
            prev = cut
        hyp = bs.stream_hyps(carry, nbest=1)[0]
        inner = [i for i in hyp.yseq if i not in (meta["sos"], meta["eos"])]
        if inner != meta["hyps"][uid]:
            mismatches.append((uid, inner, meta["hyps"][uid]))
    assert not mismatches, f"streamed golden_trained: {mismatches}"
    return len(uids)


def run_trained(device) -> Dict[str, float]:
    """The three operating points of the reference's trained checkpoint."""
    fx = load_fixture("golden_trained")
    meta = fx.meta
    model = build_trained(fx, device)
    c = meta["corpus"]
    corpus = make_tone_corpus(c["n_train"], c["n_valid"], c["seed"])
    out = check_trained(model, meta, meta, corpus, "trained")
    lm_meta = json.loads((GOLD / "golden_trained_lm.json").read_text())
    lm = build_trained_lm(lm_meta, meta["vocab"], device)
    out.update(check_trained(model, meta, lm_meta, corpus, "trained_lm", lm,
                             lm_meta["lm_weight"]))
    out["trained_streamed_utterances"] = float(check_trained_streaming(model, meta, corpus))
    return out


TRANSDUCER_SCORE_TOL = 1e-4


def build_transducer(fx: Fixture, device) -> TransducerModel:
    """The transducer with the fixture's LSTM prediction network and joint
    network, in eval mode; it takes the fixture's encoder output, so its
    encoder (one small Conformer block, features of the encoder's width)
    keeps its initial weights and never runs."""
    meta = fx.meta
    cfg = TransducerModelConfig(
        vocab_size=meta["vocab"], frontend=None, normalize="none", input_size=meta["enc_dim"],
        encoder=ConformerConfig(output_size=meta["enc_dim"], attention_heads=2, linear_units=16,
                                num_blocks=1),
        decoder=TransducerDecoderConfig(decoder_type="rnn", embed_size=meta["hidden"],
                                        hidden_size=meta["hidden"], num_layers=1),
        joint_size=meta["joint"],
    )
    model = TransducerModel(cfg, device=device)
    part = lambda prefix: {k[len(prefix):]: v for k, v in fx.sd.items()  # noqa: E731
                           if k.startswith(prefix)}
    sd = params_from_jax({"params": transducer_params(part("dec."), part("joint."))})
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.startswith("encoder.") for k in missing):
        raise AssertionError(f"golden_transducer weights: missing {missing}, "
                             f"unexpected {unexpected}")
    return model.eval()


def run_transducer(device) -> Dict[str, float]:
    """``golden_transducer``'s tsd, tsd3 and nsc 4-best lists, each entry's
    tokens identical and its score within TRANSDUCER_SCORE_TOL; returns
    each search's largest score error."""
    fx = load_fixture("golden_transducer")
    meta = fx.meta
    model = build_transducer(fx, device)
    enc = _on(model, fx.arrays["enc_out"][None])
    enc_lens = torch.tensor([meta["t"]], device=enc.device)
    out = {}
    with torch.inference_mode():
        for name, conf in meta["configs"].items():
            if conf["search_type"] == "tsd":
                hyps = transducer_tsd_decode(model, enc, enc_lens, beam_size=meta["beam"],
                                             max_sym_exp=conf["max_sym_exp"], nbest=meta["beam"])
            elif conf["search_type"] == "nsc":
                hyps = transducer_nsc_decode(model, enc, enc_lens, beam_size=meta["beam"],
                                             nstep=conf["nstep"],
                                             prefix_alpha=conf["prefix_alpha"],
                                             nbest=meta["beam"])
            else:
                continue
            want = meta["results"][name]
            got = [(h.yseq, h.score) for h in hyps]
            if [g[0] for g in got] != [w["yseq"] for w in want]:
                raise AssertionError(f"golden_transducer {name}: {got} != {want}")
            out[f"transducer_{name}"] = err = max(abs(g[1] - w["score"])
                                                  for g, w in zip(got, want))
            if not err <= TRANSDUCER_SCORE_TOL:
                raise AssertionError(f"golden_transducer {name}: scores {got} vs {want}")
    return out


def run_all(device) -> Dict[str, float]:
    """Every check of both fixtures on ``device``; raises on the first miss.
    Returns each check's largest error (score errors for the searches)."""
    fx = load_fixture("golden_conformer")
    model = build_conformer(fx, device)
    out = {**check_encoder(model, fx), **check_encoder(model, fx, long=True),
           **check_ctc_and_decoder(model, fx)}
    for case in ("beam10", "beam1", "long"):
        out[f"score_{case}"] = check_beam(model, fx, case)
    out["score_beam_over_vocab"] = check_beam_over_vocab(model, fx)
    fx = load_fixture("golden_llm_guided")
    guided = build_guided(fx, device)
    out.update({f"guided_{k}": v for k, v in check_guided_loss(guided, fx).items()})
    out["guided_dec_logp"] = check_guided_decoder(guided, fx)
    out["guided_cached_steps"] = check_guided_cached_steps(guided, fx)
    out["guided_score_beam10"] = check_guided_beam(guided, fx)
    fx = load_fixture("golden_trained_guided")
    out.update(check_trained_guided(build_trained_guided(fx, device), fx))
    out.update(run_trained(device))
    out.update(run_transducer(device))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    for name, err in run_all(args.device).items():
        print(f"golden {name}: {err:.3e}")
    print(f"golden: every check passed on {args.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
