#!/usr/bin/env python3
"""Speech translation inference API + CLI (counterpart of llm_guided_asr_tpu/bin/st_inference.py;
espnet2/bin/st_inference.py analog).

``Speech2Translation(train_config, model_file)`` rebuilds the ST model
from an experiment directory of either package (tasks/st.py
``STTask.build_model_from_file``: the port's ``.pth`` or the JAX
package's ``.msgpack``) and beam-decodes target-language text with the
JAX defaults: beam 5, ``ctc_weight`` 0 (the CTC is over the *source*
vocabulary, so it does not join the translation beam, as in the
reference's ST decode) and ``maxlenratio`` -48, a fixed 48-token cap.
The search is ``BatchBeamSearch`` with the full-prefix scorer
(search/scorers.py ``StatelessAttScorer``): every step runs the first
pass, the prompt and the LLM over the whole prefix again, as the JAX
package does.  A call returns (text, tokens, token_ids, Hypothesis) a
result; :func:`inference` writes ``1best_recog/{text,token,score}`` and
:func:`main` is the command line:

    python -m llm_guided_asr_tpu_torch.bin.st_inference --train_config exp/config.yaml \
        --model_file exp/valid.loss.ave_3best.pth --wav_scp data/test/wav.scp \
        --output_dir decode [--beam_size 5] [--device cpu]
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from llm_guided_asr_tpu_torch.bin.asr_inference import encode_request, format_results
from llm_guided_asr_tpu_torch.data.fileio import DatadirWriter, SoundScpReader
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
from llm_guided_asr_tpu_torch.utils.config import build_config

logger = logging.getLogger(__name__)


class Speech2Translation:
    """callable: speech waveform -> list of (text, tokens, token_ids,
    Hypothesis); from a model object without a tokenizer, of (token_ids,
    Hypothesis)."""

    def __init__(self, train_config: Optional[Union[str, Path]] = None,
                 model_file: Optional[Union[str, Path]] = None, beam_size: int = 5,
                 nbest: int = 1, maxlenratio: float = -48.0, penalty: float = 0.0,
                 speech_pad_multiple: int = 1600, device: Union[str, torch.device] = "cuda",
                 *, model=None, tokenizer=None):
        self.tokenizer = self.converter = self.config = None
        if model is None:
            from llm_guided_asr_tpu_torch.tasks.asr import build_text_converter
            from llm_guided_asr_tpu_torch.tasks.st import STTask

            if train_config is None:
                raise ValueError("Speech2Translation needs train_config (or from_model)")
            model, self.config = STTask.build_model_from_file(train_config, model_file, device)
            self.tokenizer, self.converter = build_text_converter(self.config)
        elif tokenizer is not None:
            from llm_guided_asr_tpu_torch.text.tokenizers import HuggingFaceTokenIDConverter

            self.tokenizer = tokenizer
            self.converter = HuggingFaceTokenIDConverter(tokenizer.tokenizer)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.maxlenratio = maxlenratio
        self.nbest = nbest
        self.speech_pad_multiple = speech_pad_multiple
        cfg = model.cfg
        self.beam = BatchBeamSearch(model, vocab_size=cfg.vocab_size, sos=cfg.sos_id,
                                    eos=cfg.eos_id, beam_size=beam_size, ctc_weight=0.0,
                                    penalty=penalty)

    @classmethod
    def from_model(cls, model, tokenizer=None, **kwargs) -> "Speech2Translation":
        """A translator over an ST model whose weights are loaded, with an
        optional LLM tokenizer (text/tokenizers.py ``HuggingFaceTokenizer``)."""
        return cls(model=model, tokenizer=tokenizer, **kwargs)

    @torch.inference_mode()
    def __call__(self, speech: np.ndarray) -> list:
        enc, enc_lens = encode_request(self.model, speech, self.speech_pad_multiple, self.device)
        hyps = self.beam(enc, enc_lens, maxlenratio=self.maxlenratio, nbest=self.nbest)
        cfg = self.model.cfg
        return format_results(hyps, self.nbest, (cfg.sos_id, cfg.eos_id), self.tokenizer,
                              self.converter)


def inference(output_dir: Union[str, Path], wav_scp: Union[str, Path],
              train_config: Union[str, Path], model_file: Optional[Union[str, Path]] = None,
              beam_size: int = 5, device: Union[str, torch.device] = "cuda"
              ) -> Speech2Translation:
    """Translate every utterance of ``wav_scp`` into
    ``<output_dir>/1best_recog/{text,token,score}``."""
    s2tr = Speech2Translation(train_config, model_file, beam_size=beam_size, device=device)
    reader = SoundScpReader(wav_scp)
    with DatadirWriter(Path(output_dir) / "1best_recog") as w:
        for uid in reader.keys():
            rate, wav = reader[uid]
            text, toks, ids, hyp = s2tr(np.asarray(wav, np.float32))[0]
            w["text"][uid] = text
            w["token"][uid] = " ".join(toks)
            w["score"][uid] = str(float(hyp.score))
    logger.info(f"translated {len(reader)} utterances -> {output_dir}")
    return s2tr


def main(cmd=None) -> Speech2Translation:
    """``--device cpu`` runs on the CPU (null: the card)."""
    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "output_dir": "st_decoded",
        "wav_scp": None,
        "train_config": None,
        "model_file": None,
        "beam_size": 5,
        "device": None,
    })
    logging.basicConfig(level=logging.INFO)
    return inference(config["output_dir"], config["wav_scp"], config["train_config"],
                     config.get("model_file"), beam_size=int(config.get("beam_size", 5)),
                     device=config.get("device") or "cuda")


if __name__ == "__main__":
    main()
