#!/usr/bin/env python3
"""End-to-end ASR recipe pipeline (counterpart of llm_guided_asr_tpu/bin/asr_pipeline.py;
egs2/TEMPLATE/asr1/asr.sh analog).

A Python stage runner over Kaldi-format data dirs (wav.scp + text), in
process, keeping the reference's stage numbering:

  stage 1   data validation (local/data.sh + validate_data_dir.sh analog)
  stage 3   wav format/validation (format_wav_scp: resolve + check audio)
  stage 4   remove long/short utterances (asr.sh:799)
  stage 5   token list generation (char; asr.sh:877-968)
  stage 6-7 LM training on the corpus text (asr.sh:1007-1159; --use_lm true)
  stage 8   LM perplexity on the valid text (asr.sh:1160)
  stage 9   n-gram ARPA (asr.sh:1179; --use_ngram true)
  stage 10  collect stats (asr.sh:1189)
  stage 11  ASR training (asr.sh:1308)
  stage 12  decoding (asr.sh:1480; shallow-fuses the stage-7 LM when trained);
            with --decode_nj N the valid/test wav.scp is split into N shards
            (bin/split_scps.py) decoded as an array job of asr_inference
            processes through utils/job.py (--cmd_backend local|stdout|
            slurm|sge|ssh, --cmd_conf <queue.conf>) and merged
  stage 13  scoring + per-utterance alignment report (asr.sh:1621)
  stage 14  pack the model bundle (asr.sh:1727, bin/pack.py)
  stage 15  the model-zoo export artifact (asr.sh:1760): the bundle and a
            model card; nothing is uploaded

Not ported yet, and raising when asked for: stage 2 (speed perturbation
needs ops/augment.py, ROADMAP Queue 1 item 12).

    python -m llm_guided_asr_tpu_torch.bin.asr_pipeline --config conf/train.yaml \
        --train_dir data/train --valid_dir data/valid --test_dir data/test \
        --expdir exp/run1 --stage 3 --stop_stage 15 [--decode_nj 4] [--device cpu]
"""

from __future__ import annotations

import json
import logging
import os
import sys
from pathlib import Path
from typing import Dict, Optional

from llm_guided_asr_tpu_torch.bin.split_scps import split_scps
from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text, read_audio
from llm_guided_asr_tpu_torch.text.tokenizers import CharTokenizer
from llm_guided_asr_tpu_torch.utils.job import JobOptions, JobRunner

logger = logging.getLogger(__name__)

DEFAULTS = {
    "config": None,
    "train_dir": None,
    "valid_dir": None,
    "test_dir": None,
    "expdir": "exp/asr",
    "stage": 3,
    "stop_stage": 13,
    "speed_perturb": None,
    "min_samples": 800,       # remove-short threshold (samples)
    "max_samples": 480000,    # remove-long threshold (30 s @ 16 kHz)
    "token_type": "char",
    "nbest": 1,
    "beam_size": 10,
    "ctc_weight": 0.3,
    "decode_nj": 1,
    "cmd_backend": "local",
    "cmd_conf": None,
    "use_lm": False,
    "lm_config": None,
    "lm_weight": 0.3,
    "use_ngram": False,
    "ngram_order": 3,
    "device": None,
}


def _read_dir(d: Path):
    return read_2columns_text(d / "wav.scp"), read_2columns_text(d / "text")


def stage1_validate(dirs: Dict[str, Path]):
    """Every split has a consistent wav.scp/text pair: duplicate or
    mismatched ids and lines without a value fail before any compute."""
    for split, d in dirs.items():
        for fname in ("wav.scp", "text"):
            if not (d / fname).exists():
                raise FileNotFoundError(f"stage1 [{split}]: missing {d / fname}")
        ids = {}
        for fname in ("wav.scp", "text"):
            acc = ids.setdefault(fname, [])
            for ln, line in enumerate((d / fname).read_text().splitlines(), 1):
                if not line.strip():
                    continue
                parts = line.split(maxsplit=1)
                if len(parts) < 2:
                    raise ValueError(f"stage1 [{split}]: {fname}:{ln} has no value: {line!r}")
                acc.append(parts[0])
            if len(set(acc)) != len(acc):
                dup = sorted({u for u in acc if acc.count(u) > 1})[:5]
                raise ValueError(f"stage1 [{split}]: duplicate ids in {fname}: {dup}")
        missing = sorted(set(ids["wav.scp"]) ^ set(ids["text"]))
        if missing:
            raise ValueError(f"stage1 [{split}]: wav.scp/text utt-id mismatch "
                             f"(first few: {missing[:5]})")
        logger.info(f"stage1 [{split}]: {len(ids['wav.scp'])} utterances ok")


def stage3_format(data_dir: Path, out_dir: Path, cfg):
    """Validate that the audio is readable; write wav.scp, text and
    utt2num_samples (format_wav_scp analog, asr.sh:614)."""
    wavs, texts = _read_dir(data_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    kept = []
    for uid, path in wavs.items():
        if uid not in texts:
            continue
        try:
            rate, data = read_audio(path)
        except Exception as e:
            logger.warning(f"stage3: dropping {uid}: {e}")
            continue
        kept.append((uid, path, len(data)))
    with open(out_dir / "wav.scp", "w") as fw, open(out_dir / "text", "w") as ft, \
            open(out_dir / "utt2num_samples", "w") as fn:
        for uid, path, n in kept:
            fw.write(f"{uid} {path}\n")
            ft.write(f"{uid} {texts[uid]}\n")
            fn.write(f"{uid} {n}\n")
    logger.info(f"stage3 [{data_dir.name}]: kept {len(kept)}/{len(wavs)}")


def stage4_filter(work_dir: Path, cfg):
    nsamples = {k: int(v) for k, v in read_2columns_text(work_dir / "utt2num_samples").items()}
    keep = {k for k, n in nsamples.items() if cfg["min_samples"] <= n <= cfg["max_samples"]}
    for name in ("wav.scp", "text", "utt2num_samples"):
        lines = (work_dir / name).read_text().splitlines()
        with open(work_dir / name, "w") as f:
            for line in lines:
                if line.split(maxsplit=1)[0] in keep:
                    f.write(line + "\n")
    logger.info(f"stage4 [{work_dir.name}]: kept {len(keep)}/{len(nsamples)}")


def stage5_token_list(train_dir: Path, out_file: Path, cfg):
    texts = read_2columns_text(train_dir / "text")
    tok = CharTokenizer()
    vocab = set()
    for t in texts.values():
        vocab.update(tok.text2tokens(t))
    token_list = ["<blank>", "<unk>"] + sorted(vocab) + ["<sos/eos>"]
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text("\n".join(token_list) + "\n")
    logger.info(f"stage5: {len(token_list)} tokens -> {out_file}")


def _model_file(exp: Path) -> Path:
    return next(exp.glob("valid.*.ave_*best.pth"), None) or exp / "latest.pth"


def _check_options(cfg):
    """Options that cannot run raise before any stage writes a file."""
    if cfg.get("speed_perturb"):
        raise NotImplementedError("--speed_perturb (stage 2) needs ops/augment.py, which is "
                                  "not ported yet (ROADMAP Queue 1 item 12)")
    if int(cfg.get("decode_nj", 1)) < 1:
        raise ValueError(f"--decode_nj must be >= 1, not {cfg['decode_nj']}")
    JobRunner(str(cfg.get("cmd_backend", "local")), conf=cfg.get("cmd_conf"))


def decode_jobs(cfg, nj: int, wav_scp: Path, dec_dir: Path, train_config: Path,
                model_file: Path, fusion: Dict):
    """Stage 12 as an array job (asr.sh:1480): ``wav_scp`` split into
    ``nj`` shards, each decoded by an asr_inference process (JOB is its
    index) through the ``--cmd_backend`` runner, their 1best_recog text,
    token and score merged in key order.  On the card a local runner takes
    one job at a time (each process builds its model on the device)."""
    shard_dir = dec_dir / "split"
    split_scps([str(wav_scp)], nj, str(shard_dir))
    args = [sys.executable, "-m", "llm_guided_asr_tpu_torch.bin.asr_inference",
            "--output_dir", str(dec_dir / "jobJOB"),
            "--data_path_and_name_and_type", f"{shard_dir}/wav.scp.JOB,speech,sound",
            "--asr_train_config", str(train_config), "--asr_model_file", str(model_file),
            "--beam_size", str(cfg["beam_size"]), "--ctc_weight", str(cfg["ctc_weight"]),
            "--nbest", str(cfg["nbest"])]
    if cfg.get("device"):
        args += ["--device", str(cfg["device"])]
    for k, v in fusion.items():
        args += [f"--{k}", str(v)]
    runner = JobRunner(str(cfg.get("cmd_backend", "local")), conf=cfg.get("cmd_conf"))
    seq = str(cfg.get("device")) != "cpu" and runner.backend in ("local", "stdout")
    package_root = str(Path(__file__).resolve().parents[2])
    env = {"PYTHONPATH": os.pathsep.join(p for p in (package_root, os.environ.get("PYTHONPATH"))
                                         if p)}
    rc = runner.run(args, str(dec_dir / "log" / "decode.JOB.log"), array=(1, nj),
                    options=JobOptions(max_jobs_run=1 if seq else None, extra_env=env))
    if rc:
        raise RuntimeError(f"decode jobs failed rc={rc} (logs: {dec_dir}/log)")
    merged = dec_dir / "1best_recog"
    merged.mkdir(parents=True, exist_ok=True)
    for name in ("text", "token", "score"):
        lines = []
        for j in range(1, nj + 1):
            f = dec_dir / f"job{j}" / "1best_recog" / name
            if f.exists():
                lines += f.read_text().splitlines()
        (merged / name).write_text("\n".join(sorted(lines)) + ("\n" if lines else ""))


def write_model_card(expdir: Path, test_split: str, stage: int, stop: int) -> Path:
    """Stage 15's model card beside the stage-14 bundle (the upload
    artifact of asr.sh:1760; there is no network to upload it)."""
    card = expdir / "pack" / "README.md"
    card.parent.mkdir(parents=True, exist_ok=True)
    lines = ["---", "tags: [automatic-speech-recognition, llm-guided-asr-tpu-torch]", "---", "",
             f"# {expdir.name}", "",
             f"Trained with llm_guided_asr_tpu_torch (asr_pipeline stages {stage}-{stop}).", ""]
    res = expdir / "score" / test_split / "result.txt"
    if res.exists():
        lines += ["## Results", "", "```", res.read_text().strip()[:2000], "```"]
    card.write_text("\n".join(lines) + "\n")
    return card


def main(cmd=None) -> Optional[dict]:
    """Run stages ``--stage``..``--stop_stage``; returns stage 13's result."""
    from llm_guided_asr_tpu_torch.utils.config import build_config

    raw = list(cmd if cmd is not None else sys.argv[1:])
    # --config names the training yaml handed to ASRTask: take it out
    # before build_config would merge it into the pipeline's options
    train_config, filtered, i = None, [], 0
    while i < len(raw):
        if raw[i] == "--config":
            train_config = raw[i + 1]
            i += 2
        elif raw[i].startswith("--config="):
            train_config = raw[i].split("=", 1)[1]
            i += 1
        else:
            filtered.append(raw[i])
            i += 1
    cfg = build_config(filtered, {**DEFAULTS})
    cfg["config"] = train_config
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    stage, stop = int(cfg["stage"]), int(cfg["stop_stage"])
    _check_options(cfg)
    expdir = Path(cfg["expdir"])
    work = expdir / "data"
    token_file = expdir / "tokens.txt"
    stats_dir = expdir / "stats"
    train_exp = expdir / "train"
    dirs = {"train": Path(cfg["train_dir"]), "valid": Path(cfg["valid_dir"])}
    if cfg.get("test_dir"):
        dirs["test"] = Path(cfg["test_dir"])
    test_split = "test" if "test" in dirs else "valid"

    if stage <= 1 <= stop:
        stage1_validate(dirs)
    if stage <= 3 <= stop:
        for split, d in dirs.items():
            stage3_format(d, work / split, cfg)
    if stage <= 4 <= stop:
        for split in dirs:
            stage4_filter(work / split, cfg)
    if stage <= 5 <= stop:
        stage5_token_list(work / "train", token_file, cfg)

    device_args = ["--device", str(cfg["device"])] if cfg.get("device") else []
    train_args = (["--config", str(cfg["config"])] if cfg.get("config") else []) + device_args
    data_args = [
        "--token_list", str(token_file),
        "--train_data_path_and_name_and_type",
        json.dumps([[str(work / "train" / "wav.scp"), "speech", "sound"],
                    [str(work / "train" / "text"), "text", "text"]]),
        "--valid_data_path_and_name_and_type",
        json.dumps([[str(work / "valid" / "wav.scp"), "speech", "sound"],
                    [str(work / "valid" / "text"), "text", "text"]]),
    ]
    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask

    lm_exp = expdir / "lm"
    if cfg.get("use_lm") and stage <= 7 <= stop:
        # stages 6-7: the LM on the corpus text (asr.sh:1007)
        from llm_guided_asr_tpu_torch.tasks.lm import LMTask

        lm_args = ["--token_list", str(token_file)] + device_args
        if cfg.get("lm_config"):
            lm_args += ["--config", str(cfg["lm_config"])]
        LMTask.main(lm_args + [
            "--train_data_path_and_name_and_type",
            json.dumps([[str(work / "train" / "text"), "text", "text"]]),
            "--valid_data_path_and_name_and_type",
            json.dumps([[str(work / "valid" / "text"), "text", "text"]]),
            "--output_dir", str(lm_exp),
        ])
    if cfg.get("use_lm") and stage <= 8 <= stop:
        from llm_guided_asr_tpu_torch.tasks.lm import calc_perplexity

        ppl = calc_perplexity(lm_exp / "config.yaml", _model_file(lm_exp),
                              [(str(work / "valid" / "text"), "text", "text")],
                              device=cfg.get("device") or "cuda")
        (lm_exp / "perplexity_valid").write_text(f"{ppl}\n")
        logger.info(f"stage8: valid perplexity = {ppl:.2f}")
    ngram_file = expdir / "ngram" / f"{cfg.get('ngram_order', 3)}gram.arpa"
    if cfg.get("use_ngram") and stage <= 9 <= stop:
        from llm_guided_asr_tpu_torch.search.ngram import build_arpa

        texts = read_2columns_text(work / "train" / "text")
        if cfg["token_type"] == "char":
            sents = [list(t.replace(" ", "")) for t in texts.values()]
        else:
            sents = [t.split() for t in texts.values()]
        ngram_file.parent.mkdir(parents=True, exist_ok=True)
        build_arpa(sents, ngram_file, order=int(cfg.get("ngram_order", 3)))
        logger.info(f"stage9: wrote {ngram_file}")

    if stage <= 10 <= stop:
        ASRTask.main(train_args + data_args + ["--collect_stats", "true",
                                               "--output_dir", str(stats_dir)])
    if stage <= 11 <= stop:
        ASRTask.main(train_args + data_args + [
            "--output_dir", str(train_exp),
            "--normalize_conf", f"stats_file={stats_dir / 'train' / 'feats_stats.npz'}",
        ])
    if stage <= 12 <= stop:
        from llm_guided_asr_tpu_torch.bin.asr_inference import inference

        fusion = {}
        if cfg.get("use_lm") and (lm_exp / "config.yaml").exists():
            fusion = dict(lm_train_config=str(lm_exp / "config.yaml"),
                          lm_file=str(_model_file(lm_exp)),
                          lm_weight=float(cfg.get("lm_weight", 0.3)))
        nj = int(cfg.get("decode_nj", 1))
        if nj <= 1:
            inference(str(expdir / "decode" / test_split),
                      [(str(work / test_split / "wav.scp"), "speech", "sound")],
                      str(train_exp / "config.yaml"), str(_model_file(train_exp)),
                      beam_size=int(cfg["beam_size"]), ctc_weight=float(cfg["ctc_weight"]),
                      nbest=int(cfg["nbest"]), device=cfg.get("device") or "cuda", **fusion)
        else:
            decode_jobs(cfg, nj, work / test_split / "wav.scp", expdir / "decode" / test_split,
                        train_exp / "config.yaml", _model_file(train_exp), fusion)
    result = None
    if stage <= 13 <= stop:
        from llm_guided_asr_tpu_torch.bin.score import score

        result = score(str(work / test_split / "text"),
                       str(expdir / "decode" / test_split / "1best_recog" / "text"),
                       str(expdir / "score" / test_split),
                       token_type="char" if cfg["token_type"] == "char" else "word")
        logger.info(f"stage13 [{test_split}]: {result['metric']}={result['err']:.2f}")
        print(json.dumps(result))
    if stage <= 14 <= stop:
        from llm_guided_asr_tpu_torch.bin.pack import pack

        stats = stats_dir / "train" / "feats_stats.npz"
        bundle = pack(str(expdir / "pack" / "asr_model.zip"), str(train_exp / "config.yaml"),
                      str(_model_file(train_exp)),
                      stats_file=str(stats) if stats.exists() else None)
        logger.info(f"stage14: packed -> {bundle}")
    if stage <= 15 <= stop:
        card = write_model_card(expdir, test_split, stage, stop)
        logger.info(f"stage15: export artifact ready under {card.parent} (nothing is uploaded)")
    return result


if __name__ == "__main__":
    main()
