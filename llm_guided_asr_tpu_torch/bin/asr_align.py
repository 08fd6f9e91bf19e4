#!/usr/bin/env python3
"""CTC forced alignment CLI (counterpart of llm_guided_asr_tpu/bin/asr_align.py;
espnet2/bin/asr_align.py analog).

Aligns each transcript to its audio by the Viterbi over the
blank-interleaved CTC graph (ops/ctc_align.py) and writes Kaldi
``segments`` rows ``<uid>_<idx> <uid> <start_s> <end_s>`` and an
``aligned`` file of ``<uid> token:start:end ...`` (seconds).  A frame is
the frontend's hop times the encoder's subsampling (4 under ``conv2d``).

    python -m llm_guided_asr_tpu_torch.bin.asr_align --asr_train_config exp/config.yaml \
        --asr_model_file exp/valid.loss.ave_1best.pth --wav_scp wav.scp --text text \
        --output_dir aligned [--device cpu]
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Dict, Optional, Union

import torch

logger = logging.getLogger(__name__)


@torch.inference_mode()
def align(output_dir: Union[str, Path], wav_scp: str, text: str, asr_train_config: str,
          asr_model_file: Optional[str] = None, fs: int = 16000,
          device: Union[str, torch.device] = "cuda") -> Dict[str, list]:
    """Align every utterance of ``wav_scp`` that ``text`` transcribes;
    returns {uid: [(token, start_s, end_s), ...]}."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text, encode_request
    from llm_guided_asr_tpu_torch.data.fileio import SoundScpReader, read_2columns_text
    from llm_guided_asr_tpu_torch.ops.ctc_align import ctc_forced_align, token_boundaries

    s2t = Speech2Text(asr_train_config, asr_model_file, beam_size=1, ctc_weight=1.0,
                      device=device)
    model = s2t.model
    fcfg = model.cfg.frontend
    hop_s = (fcfg.hop_length if fcfg is not None else 160) / fs
    frame_s = hop_s * (4 if model.cfg.encoder.input_layer == "conv2d" else 1)

    reader = SoundScpReader(wav_scp)
    texts = read_2columns_text(text)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    result: Dict[str, list] = {}
    with open(out / "segments", "w") as seg, open(out / "aligned", "w") as alf:
        for uid in reader.keys():
            if uid not in texts:
                continue
            _, wav = reader[uid]
            tokens = s2t.tokenizer.text2tokens(texts[uid])
            ids = s2t.converter.tokens2ids(tokens)
            if not ids:
                continue
            enc, enc_lens = encode_request(model, wav, s2t.speech_pad_multiple, s2t.device)
            logp = model.ctc_log_softmax(enc)[0]  # [T, V]
            _, toks = ctc_forced_align(logp, torch.tensor(ids), enc_lens[0])
            parts, result[uid] = [], []
            for u, (tok, (b0, b1)) in enumerate(zip(tokens, token_boundaries(toks, len(ids)))):
                t0, t1 = b0 * frame_s, b1 * frame_s
                seg.write(f"{uid}_{u:04d} {uid} {t0:.3f} {t1:.3f}\n")
                parts.append(f"{tok}:{t0:.3f}:{t1:.3f}")
                result[uid].append((tok, t0, t1))
            alf.write(f"{uid} {' '.join(parts)}\n")
    logger.info(f"aligned {len(result)} utterances -> {out}")
    return result


def main(cmd=None) -> Dict[str, list]:
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "output_dir": "aligned",
        "wav_scp": None,
        "text": None,
        "asr_train_config": None,
        "asr_model_file": None,
        "fs": 16000,
        "device": "cuda",
    })
    logging.basicConfig(level=logging.INFO)
    return align(config["output_dir"], config["wav_scp"], config["text"],
                 config["asr_train_config"], config.get("asr_model_file"),
                 fs=int(config.get("fs") or 16000), device=config.get("device") or "cuda")


if __name__ == "__main__":
    main()
