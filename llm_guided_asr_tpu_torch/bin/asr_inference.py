#!/usr/bin/env python3
"""Speech2Text inference API + CLI (counterpart of llm_guided_asr_tpu/bin/asr_inference.py).

Rebuild of espnet2/bin/asr_inference.py (Speech2Text:89, inference():710).
``Speech2Text(asr_train_config, asr_model_file, ...)`` rebuilds the model
from an experiment directory of either package (tasks/asr.py
``ASRTask.build_model_from_file``: the port's ``.pth`` or the JAX package's
``.msgpack``) with the JAX defaults (``ctc_weight`` 0.5, ``beam_size``
10), builds the tokenizer and token converter of the config, and returns
(text, tokens, token_ids, Hypothesis) a result.  ``Speech2Text.from_model``
takes a model whose weights are already loaded (ctc_weight 0.3 unless
given); its results are (token_ids, Hypothesis) pairs, or the 4-tuples
when a tokenizer is given.  ``Speech2Text.from_packed(archive)`` reads a
bin/pack.py archive.

A call pads the waveform to a multiple of ``speech_pad_multiple`` samples,
encodes it and searches:

- the LLM-guided model (a model with ``decode_prefix``): the beam search
  with the cached guided scorer; ``biasing_words`` are tokenized with the
  LLM tokenizer and packed at the template's ``((BIAS))`` slot, per call;
- the CTC/attention ASRModel: the beam search with the stateless
  full-prefix scorer, or with the per-beam KV cache of
  search/cached_decoder.py when ``use_cached_decoder``; the greedy CTC
  decode when ``beam_size <= 1`` and ``ctc_weight == 1.0``;
- shallow fusion (asr_inference.py:184-196): ``lm_train_config`` and
  ``lm_file`` (tasks/lm.py ``LMTask``), or an ``lm`` object (a language
  model of models/lm.py or a score function (tokens [N, L], lengths [N])
  -> log-probs [N, V]); the search adds it with ``lm_weight``;
- a transducer (a model with ``joint_full``): with ``beam_size > 1`` the
  ``transducer_search`` (``default``: the fixed-expansion beam; ``alsd``,
  ``tsd``, ``nsc``), the greedy decode when it is 1, and ``mbg`` (the
  multi-blank greedy over the model's big blanks) at any beam size.

``batch_call`` decodes several requests in one encode and one lockstep
beam search (``BatchBeamSearch.batch_decode``); it decodes them one by one
where the JAX package does: for a transducer and for a model without a
beam search.  :func:`inference` writes ``1best_recog/{text,token,score,
score_*}`` and the ``rtf`` file; :func:`main` is the command line.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from llm_guided_asr_tpu_torch.data.fileio import DatadirWriter, SoundScpReader, read_2columns_text
from llm_guided_asr_tpu_torch.models.lm import make_lm_score_fn
from llm_guided_asr_tpu_torch.models.transducer import transducer_greedy_decode
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch, Hypothesis
from llm_guided_asr_tpu_torch.search.cached_decoder import CachedDecoderScorer
from llm_guided_asr_tpu_torch.search.greedy import ctc_greedy_decode
from llm_guided_asr_tpu_torch.search.scorers import CachedGuidedScorer
from llm_guided_asr_tpu_torch.search.transducer_beam import (
    transducer_alsd_decode,
    transducer_beam_decode,
)
from llm_guided_asr_tpu_torch.search.transducer_extra import (
    transducer_multiblank_greedy,
    transducer_nsc_decode,
    transducer_tsd_decode,
)
from llm_guided_asr_tpu_torch.text.tokenizers import (
    HuggingFaceTokenIDConverter,
    HuggingFaceTokenizer,
)
from llm_guided_asr_tpu_torch.utils.config import build_config, normalize_triples

logger = logging.getLogger(__name__)

TRANSDUCER_BEAMS = {"default": transducer_beam_decode, "alsd": transducer_alsd_decode,
                    "tsd": transducer_tsd_decode, "nsc": transducer_nsc_decode}
TRANSDUCER_SEARCHES = tuple(TRANSDUCER_BEAMS) + ("mbg",)


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def encode_request(model: nn.Module, speech: np.ndarray, pad_multiple: int,
                   device: torch.device):
    """One waveform ([S], or [S, C] for the multichannel frontend) padded
    with zeros to a multiple of ``pad_multiple`` samples, then
    ``model.encode`` -> (enc [1, T', D], lengths [1])."""
    speech = np.asarray(speech, np.float32)
    n = speech.shape[0]
    padded = np.zeros((round_up(max(n, 1), pad_multiple),) + speech.shape[1:], np.float32)
    padded[:n] = speech
    return model.encode(torch.from_numpy(padded[None]).to(device), torch.tensor([n], device=device))


def format_results(hyps: List[Hypothesis], nbest: int, special: Sequence[int],
                   tokenizer=None, converter=None) -> list:
    """The first ``nbest`` hypotheses without the ``special`` ids (sos,
    eos): (token_ids, Hypothesis) each, or (text, tokens, token_ids,
    Hypothesis) with a tokenizer."""
    out = []
    for h in hyps[:nbest]:
        ids = [i for i in h.yseq if i not in special]
        if tokenizer is None:
            out.append((ids, h))
        else:
            tokens = converter.ids2tokens(ids)
            out.append((tokenizer.tokens2text(tokens), tokens, ids, h))
    return out


class Speech2Text:
    """callable: speech waveform -> list of (text, tokens, token_ids,
    Hypothesis); from a model object without a tokenizer, of (token_ids,
    Hypothesis)."""

    def __init__(
        self,
        asr_train_config: Optional[Union[str, Path]] = None,
        asr_model_file: Optional[Union[str, Path]] = None,
        token_type: Optional[str] = None,
        bpemodel: Optional[str] = None,
        lm_train_config: Optional[Union[str, Path]] = None,
        lm_file: Optional[Union[str, Path]] = None,
        lm_weight: float = 1.0,
        ctc_weight: float = 0.5,
        beam_size: int = 10,
        penalty: float = 0.0,
        maxlenratio: float = 0.0,
        minlenratio: float = 0.0,
        nbest: int = 1,
        speech_pad_multiple: int = 1600,
        use_cached_decoder: bool = False,
        transducer_search: str = "default",
        device: Union[str, torch.device] = "cuda",
        dtype: Optional[torch.dtype] = None,
        *,
        model: Optional[nn.Module] = None,
        tokenizer: Optional[HuggingFaceTokenizer] = None,
        lm: Optional[Union[nn.Module, Callable]] = None,
        pre_beam_ratio: float = 1.5,
    ):
        """From files: ``asr_train_config`` (config.yaml) and
        ``asr_model_file`` (.pth or .msgpack) on ``device``; ``token_type``
        and ``bpemodel`` override the config's.  From a model object:
        ``model`` (its own device), with an optional LLM ``tokenizer``.  ``use_cached_decoder``: the
        standard decoder scores with its per-beam KV cache (opt in, as in
        JAX).  ``lm_train_config``/``lm_file`` or ``lm``, ``lm_weight``:
        shallow fusion (the weight is 0 without an LM); ``pre_beam_ratio``:
        the pre-beam keeps int(ratio * beam) candidates a hypothesis.
        ``dtype``: the compute dtype of the model built from files, float32
        by default (as JAX's, whatever ``train_dtype`` trained it) or
        bfloat16; a model object computes in its own."""
        if isinstance(asr_train_config, nn.Module):
            raise TypeError("a model object goes to Speech2Text.from_model(model, ...)")
        self.config = None
        if model is None:
            if asr_train_config is None:
                raise ValueError("Speech2Text needs asr_train_config (or from_model)")
            from llm_guided_asr_tpu_torch.tasks.asr import ASRTask, build_text_converter

            model, self.config = ASRTask.build_model_from_file(
                asr_train_config, asr_model_file, device, dtype or torch.float32)
            tc_config = dict(self.config)
            if token_type:
                tc_config["token_type"] = token_type
            if bpemodel:
                tc_config["bpemodel"] = bpemodel
            tokenizer, converter = build_text_converter(tc_config)
        else:
            if dtype is not None:
                raise ValueError("dtype is for a model built from files; a model object "
                                 "computes in its own")
            converter = (None if tokenizer is None
                         else HuggingFaceTokenIDConverter(tokenizer.tokenizer))
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.maxlenratio = maxlenratio
        self.minlenratio = minlenratio
        self.nbest = nbest
        self.speech_pad_multiple = speech_pad_multiple
        self.beam_size = beam_size
        self.ctc_weight = ctc_weight
        self.is_transducer = hasattr(model, "joint_full")
        self.beam = None
        self.tokenizer = tokenizer
        self.converter = converter
        if lm_train_config is not None:
            from llm_guided_asr_tpu_torch.tasks.lm import LMTask

            lm, _ = LMTask.build_model_from_file(lm_train_config, lm_file, self.device)
        if isinstance(lm, nn.Module):
            lm = make_lm_score_fn(getattr(lm, "lm", lm))
        self.lm_weight = lm_weight if lm is not None else 0.0
        cfg = model.cfg
        if self.is_transducer:
            if transducer_search not in TRANSDUCER_SEARCHES:
                raise ValueError(f"transducer_search={transducer_search!r}; expected one of "
                                 f"{TRANSDUCER_SEARCHES}")
            self.transducer_search = transducer_search
        elif beam_size > 1 or ctc_weight < 1.0:
            # the guided model scores with its shared-prefix KV cache, any
            # other attention model with the stateless full-prefix scorer or,
            # opted in, the standard decoder's per-beam KV cache
            att_scorer = None
            if hasattr(model, "decode_prefix"):
                att_scorer = CachedGuidedScorer(model)
            elif use_cached_decoder and hasattr(model, "decoder") and cfg.ctc_weight < 1.0:
                att_scorer = CachedDecoderScorer(model, cfg.decoder.attention_heads,
                                                 cfg.decoder.num_blocks)
            self.beam = BatchBeamSearch(
                model, vocab_size=cfg.vocab_size, sos=cfg.sos_id, eos=cfg.eos_id,
                beam_size=max(beam_size, 1), ctc_weight=ctc_weight, penalty=penalty,
                lm_score_fn=lm, lm_weight=self.lm_weight, blank_id=cfg.blank_id,
                pre_beam_ratio=pre_beam_ratio, att_scorer=att_scorer,
            )

    @classmethod
    def from_model(cls, model: nn.Module, ctc_weight: float = 0.3, beam_size: int = 10,
                   tokenizer: Optional[HuggingFaceTokenizer] = None, **kwargs) -> "Speech2Text":
        """A recognizer over a model whose weights are loaded (the in-memory
        form; ``ctc_weight`` 0.3 by default, the guided recipe's)."""
        return cls(model=model, ctc_weight=ctc_weight, beam_size=beam_size,
                   tokenizer=tokenizer, **kwargs)

    @classmethod
    def from_packed(cls, archive: Union[str, Path], workdir: Optional[str] = None,
                    **kwargs) -> "Speech2Text":
        """From a bin/pack.py archive (the from_pretrained analog): unpacked
        into ``workdir`` (a new temporary directory by default)."""
        import tempfile

        from llm_guided_asr_tpu_torch.bin.pack import unpack

        workdir = workdir or tempfile.mkdtemp(prefix="s2t_packed_")
        files = unpack(archive, workdir)
        return cls(files["asr_train_config"], files.get("asr_model_file"), **kwargs)

    def _transducer_search(self, enc, enc_lens) -> List[Hypothesis]:
        cfg = self.model.cfg
        if self.transducer_search == "mbg":
            return transducer_multiblank_greedy(self.model, enc, enc_lens, cfg.big_blank_ids,
                                                cfg.multi_blank_durations)
        if self.beam_size > 1:
            return TRANSDUCER_BEAMS[self.transducer_search](
                self.model, enc, enc_lens, beam_size=self.beam_size, nbest=self.nbest)
        tokens, n = transducer_greedy_decode(self.model, enc, enc_lens)
        return [Hypothesis(yseq=tokens[0, : int(n[0])].tolist(), score=0.0, scores={})]

    def make_bias_ctx(self, words: Optional[Sequence[str]], pad_multiple: int = 64):
        """Per-utterance contextual biasing: the words joined by ", ",
        tokenized with the LLM tokenizer (a leading bos dropped), padded to a
        multiple of ``pad_multiple`` ids -> (ids [1, W], lengths [1]) on the
        model's device, or None where there is nothing to bias."""
        scorer = self.beam.att_scorer if self.beam is not None else None
        if not isinstance(scorer, CachedGuidedScorer) or not words:
            return None
        if not isinstance(self.tokenizer, HuggingFaceTokenizer):
            raise ValueError("biasing words need the LLM tokenizer (tokenizer=HuggingFaceTokenizer)")
        llm_tok = self.tokenizer.tokenizer
        ids = llm_tok(", ".join(words))["input_ids"]
        if llm_tok.bos_token_id is not None and ids and ids[0] == llm_tok.bos_token_id:
            ids = ids[1:]
        w = round_up(max(len(ids), 1), pad_multiple)
        arr = np.zeros((1, w), np.int64)
        arr[0, : len(ids)] = ids[:w]
        return (torch.from_numpy(arr).to(self.device),
                torch.tensor([min(len(ids), w)], device=self.device))

    def _results(self, hyps: List[Hypothesis]) -> list:
        return format_results(hyps, self.nbest, (self.model.cfg.sos_id, self.model.cfg.eos_id),
                              self.tokenizer, self.converter)

    @torch.inference_mode()
    def __call__(self, speech: np.ndarray, biasing_words: Optional[Sequence[str]] = None) -> list:
        """Decode one utterance (asr_inference.py Speech2Text.__call__:491)."""
        bias_ctx = self.make_bias_ctx(biasing_words)
        enc, enc_lens = encode_request(self.model, speech, self.speech_pad_multiple, self.device)
        if self.is_transducer:
            hyps = self._transducer_search(enc, enc_lens)
        elif self.beam is not None:
            hyps = self.beam(enc, enc_lens, maxlenratio=self.maxlenratio,
                             minlenratio=self.minlenratio, nbest=self.nbest, scorer_ctx=bias_ctx)
        else:
            tokens, n = ctc_greedy_decode(self.model.ctc_log_softmax(enc), enc_lens,
                                          blank_id=self.model.cfg.blank_id)
            hyps = [Hypothesis(yseq=tokens[0, : int(n[0])].tolist(), score=0.0, scores={})]
        return self._results(hyps)

    @torch.inference_mode()
    def batch_call(self, speeches: Sequence[np.ndarray]) -> List[list]:
        """Decode several requests in one encode and one lockstep beam
        search: the batch is padded to the longest request rounded up to
        ``speech_pad_multiple``, each request ([S], or [S, C] for the
        multichannel frontend, as :func:`encode_request` takes it) in a row.
        A transducer or a model without a beam search decodes them one by
        one, as in the JAX package."""
        if self.beam is None or self.is_transducer:
            return [self(s) for s in speeches]
        speeches = [np.asarray(s, np.float32) for s in speeches]
        channels = {s.shape[1:] for s in speeches}
        if len(channels) != 1:
            raise ValueError(f"batch_call: requests of different channel shapes {channels}")
        n = round_up(max(max(s.shape[0] for s in speeches), 1), self.speech_pad_multiple)
        batch = np.zeros((len(speeches), n) + channels.pop(), np.float32)
        lens = np.zeros((len(speeches),), np.int64)
        for i, s in enumerate(speeches):
            batch[i, : s.shape[0]] = s
            lens[i] = s.shape[0]
        enc, enc_lens = self.model.encode(torch.from_numpy(batch).to(self.device),
                                          torch.from_numpy(lens).to(self.device))
        per_utt = self.beam.batch_decode(enc, enc_lens, maxlenratio=self.maxlenratio,
                                         minlenratio=self.minlenratio, nbest=self.nbest)
        return [self._results(hyps) for hyps in per_utt]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inference(output_dir: Union[str, Path],
              data_path_and_name_and_type: Sequence[Tuple[str, str, str]],
              asr_train_config: Union[str, Path],
              asr_model_file: Optional[Union[str, Path]] = None,
              biasing_words_file: Optional[Union[str, Path]] = None,
              batch_size: int = 1, **kwargs) -> Speech2Text:
    """Decode a wav.scp into ``<output_dir>/1best_recog/{text,token,score,
    score_*}`` and write ``<output_dir>/rtf`` (asr_inference.py
    inference():710; ``biasing_words_file`` gives each utterance its
    biasing words, asr_inference_new.py:844-855).  ``batch_size > 1``
    decodes length-sorted batches with ``batch_call``.  Returns the
    recognizer."""
    s2t = Speech2Text(asr_train_config, asr_model_file, **kwargs)
    bias_table = {}
    if biasing_words_file:
        bias_table = {k: v.split() for k, v in read_2columns_text(biasing_words_file).items()}
    wav_path = next((p for p, name, _ in data_path_and_name_and_type if name == "speech"), None)
    if wav_path is None:
        raise ValueError("need a ('<wav.scp>', 'speech', 'sound') triple")
    reader = SoundScpReader(wav_path)

    def write_result(writer, uid, results):
        text, tokens, ids, hyp = results[0]
        writer["text"][uid] = text
        writer["token"][uid] = " ".join(tokens)
        writer["score"][uid] = str(float(hyp.score))
        for name, val in (hyp.scores or {}).items():
            writer[f"score_{name}"][uid] = str(float(val))

    total_audio_s, total_decode_s = 0.0, 0.0
    with DatadirWriter(Path(output_dir) / "1best_recog") as writer:
        if batch_size > 1 and not bias_table:
            # length-sorted batches share padded shapes
            uids = sorted(reader.keys())
            wavs = {u: reader[u] for u in uids}
            uids.sort(key=lambda u: len(wavs[u][1]))
            for i in range(0, len(uids), batch_size):
                chunk = uids[i : i + batch_size]
                t0 = time.perf_counter()
                per_utt = s2t.batch_call([wavs[u][1] for u in chunk])
                _sync(s2t.device)
                total_decode_s += time.perf_counter() - t0
                total_audio_s += sum(len(wavs[u][1]) / float(wavs[u][0]) for u in chunk)
                for uid, results in zip(chunk, per_utt):
                    write_result(writer, uid, results)
        else:
            for uid in reader.keys():
                rate, wav = reader[uid]
                t0 = time.perf_counter()
                results = s2t(wav, biasing_words=bias_table.get(uid))
                _sync(s2t.device)
                total_decode_s += time.perf_counter() - t0
                total_audio_s += len(wav) / float(rate)
                write_result(writer, uid, results)
    # the first call's warm-up is included, as in the JAX package
    if total_decode_s > 0:
        rtf = total_decode_s / max(total_audio_s, 1e-9)
        (Path(output_dir) / "rtf").write_text(
            f"decode_s {total_decode_s:.3f}\naudio_s {total_audio_s:.3f}\n"
            f"RTF {rtf:.4f}\nRTFx {1.0 / max(rtf, 1e-9):.2f}\n")
        logger.info(f"decode RTF={rtf:.4f} (RTFx={1.0 / max(rtf, 1e-9):.1f})")
    logger.info(f"decoded {len(reader)} utterances -> {output_dir}")
    return s2t


INFERENCE_DEFAULTS = {
    "output_dir": "decode",
    "data_path_and_name_and_type": [],
    "asr_train_config": None,
    "asr_model_file": None,
    "lm_train_config": None,
    "lm_file": None,
    "lm_weight": 1.0,
    "ctc_weight": 0.5,
    "beam_size": 10,
    "penalty": 0.0,
    "maxlenratio": 0.0,
    "minlenratio": 0.0,
    "nbest": 1,
    "batch_size": 1,
    "biasing_words_file": None,
    "use_cached_decoder": False,
    "transducer_search": "default",
    "device": "cuda",
}


def main(cmd=None) -> Speech2Text:
    """``--asr_train_config exp/config.yaml --asr_model_file exp/x.pth
    --data_path_and_name_and_type wav.scp,speech,sound --output_dir d``;
    ``--device cpu`` runs on the CPU (the card otherwise)."""
    config = build_config(cmd if cmd is not None else sys.argv[1:], INFERENCE_DEFAULTS)
    logging.basicConfig(level=logging.INFO)
    return inference(
        config["output_dir"],
        normalize_triples(config["data_path_and_name_and_type"]),
        config["asr_train_config"],
        config.get("asr_model_file"),
        biasing_words_file=config.get("biasing_words_file"),
        batch_size=int(config.get("batch_size", 1)),
        lm_train_config=config.get("lm_train_config"),
        lm_file=config.get("lm_file"),
        lm_weight=float(config.get("lm_weight", 1.0)),
        ctc_weight=float(config.get("ctc_weight", 0.5)),
        beam_size=int(config.get("beam_size", 10)),
        penalty=float(config.get("penalty", 0.0)),
        maxlenratio=float(config.get("maxlenratio", 0.0)),
        minlenratio=float(config.get("minlenratio", 0.0)),
        nbest=int(config.get("nbest", 1)),
        use_cached_decoder=bool(config.get("use_cached_decoder", False)),
        transducer_search=config.get("transducer_search", "default"),
        device=config.get("device") or "cuda",
    )


if __name__ == "__main__":
    main()
