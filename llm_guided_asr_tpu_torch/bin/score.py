#!/usr/bin/env python3
"""WER/CER scoring of Kaldi-style ref/hyp text files (counterpart of
llm_guided_asr_tpu/bin/score.py; the stage-13 sclite analog).

Reads two 'uttid text...' files, aligns them with the plain Levenshtein
aligner of utils/metrics.py and writes ``result.json``, the sclite-style
per-utterance ``result.txt`` and ``per_utt.txt`` (asr.sh:1621-1726
scoring, minus SCTK).

    python -m llm_guided_asr_tpu_torch.bin.score --ref data/valid/text \
        --hyp decode/1best_recog/text --output_dir score --token_type char
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Optional

from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text
from llm_guided_asr_tpu_torch.utils.metrics import align, corpus_bleu, error_rate

logger = logging.getLogger(__name__)


def _report_row(ops):
    rrow, hrow = [], []
    for op, r, h in ops:
        r = "" if r is None else str(r)
        h = "" if h is None else str(h)
        w = max(len(r), len(h), 1)
        if op == "C":
            rrow.append(r.ljust(w))
            hrow.append(h.ljust(w))
        elif op == "S":
            rrow.append(r.upper().ljust(w))
            hrow.append(h.upper().ljust(w))
        elif op == "D":
            rrow.append(r.upper().ljust(w))
            hrow.append(("*" * len(r)).ljust(w))
        else:
            rrow.append(("*" * len(h)).ljust(w))
            hrow.append(h.upper().ljust(w))
    return rrow, hrow


def score(ref_file: str, hyp_file: str, output_dir: Optional[str] = None,
          token_type: str = "word") -> dict:
    refs = read_2columns_text(ref_file)
    hyps = read_2columns_text(hyp_file)
    uids = sorted(set(refs) & set(hyps))
    missing = sorted(set(refs) - set(hyps))
    if missing:
        logger.warning(f"{len(missing)} utterances missing from hyp")

    def split(s):
        return s.split() if token_type in ("word", "bleu") else list(s.replace(" ", ""))

    if token_type == "bleu":
        result = {"bleu": corpus_bleu([split(refs[u]) for u in uids],
                                      [split(hyps[u]) for u in uids]),
                  "n_utts": len(uids), "metric": "BLEU"}
    else:
        result = error_rate((split(refs[u]) for u in uids), (split(hyps[u]) for u in uids))
        result["metric"] = "WER" if token_type == "word" else "CER"
    if output_dir:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "result.json", "w") as f:
            json.dump(result, f, indent=1)
        if token_type == "bleu":
            return result  # no alignment report for BLEU scoring
        per_utt = []
        with open(out / "result.txt", "w", encoding="utf-8") as f:
            for u in uids:
                ops = align(split(refs[u]), split(hyps[u]))
                n_err = sum(op != "C" for op, _, _ in ops)
                n_ref = sum(op != "I" for op, _, _ in ops)
                per_utt.append((u, n_err, n_ref))
                rrow, hrow = _report_row(ops)
                counts = {k: sum(op == k for op, _, _ in ops) for k in "CSDI"}
                f.write(f"id: ({u})\n")
                f.write(f"Scores: (#C #S #D #I) {counts['C']} {counts['S']} "
                        f"{counts['D']} {counts['I']}\n")
                f.write("REF:  " + " ".join(rrow) + "\n")
                f.write("HYP:  " + " ".join(hrow) + "\n\n")
        with open(out / "per_utt.txt", "w", encoding="utf-8") as f:
            for u, n_err, n_ref in sorted(per_utt, key=lambda x: -x[1]):
                f.write(f"{u} {n_err} {n_ref} {100.0 * n_err / max(n_ref, 1):.2f}\n")
    return result


def main(cmd=None) -> dict:
    from llm_guided_asr_tpu_torch.utils.config import build_config

    config = build_config(cmd if cmd is not None else sys.argv[1:], {
        "ref": None, "hyp": None, "output_dir": None, "token_type": "word",
    })
    logging.basicConfig(level=logging.INFO)
    result = score(config["ref"], config["hyp"], config.get("output_dir"),
                   config.get("token_type", "word"))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
