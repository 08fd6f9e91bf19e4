"""Port vs JAX, the command-line tools: ``score`` and ``tokenize_text``
write byte-equal files; ``asr_pipeline`` stages 1 and 3-5 write byte-equal
data directories and token lists, and the port's stages 10-13 run a
1-epoch recipe to a well-formed score (the LM stages 7-8 and the n-gram
stage 9 with it); the options the port lacks raise, naming their ROADMAP
item; ``ez.Trainer`` trains the tiny model from memory; asr_inference's
batched branch and the asr_inference_new shim."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_pipeline as jpipeline
from llm_guided_asr_tpu.bin import score as jscore
from llm_guided_asr_tpu.bin import tokenize_text as jtokenize
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch import ez
from llm_guided_asr_tpu_torch.bin import asr_inference, asr_inference_new, asr_pipeline, score
from llm_guided_asr_tpu_torch.bin import tokenize_text
from llm_guided_asr_tpu_torch.data.fileio import read_2columns_text, read_audio
from test_torch_task import ENC, DEC, make_corpus

REFS = ["u1 the cat sat", "u2 a b c", "u3 hello", "u4 x y z w", "u5 one two"]
HYPS = ["u1 the cat sit", "u2 a c", "u3 hello there", "u4 x y z w", "u6 extra"]


@pytest.mark.parametrize("token_type", ["word", "char", "bleu"])
def test_score_files_are_byte_equal(tmp_path, token_type):
    (tmp_path / "ref").write_text("\n".join(REFS) + "\n")
    (tmp_path / "hyp").write_text("\n".join(HYPS) + "\n")
    args = ["--ref", str(tmp_path / "ref"), "--hyp", str(tmp_path / "hyp"),
            "--token_type", token_type]
    jscore.main(args + ["--output_dir", str(tmp_path / "j")])
    got = score.main(args + ["--output_dir", str(tmp_path / "t")])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert got == json.loads((tmp_path / "j" / "result.json").read_text())


@pytest.mark.parametrize("args", [[], ["--write_vocabulary", "true", "--add_symbol",
                                       "<blank>:0", "<unk>:1", "<sos/eos>:-1"],
                                  ["--token_type", "word", "--write_vocabulary", "true",
                                   "--cutoff", "0", "--vocabulary_size", "3"],
                                  ["--field", "1-", "--token_type", "phn"]])
def test_tokenize_text_files_are_byte_equal(tmp_path, args):
    (tmp_path / "text").write_text("\n".join(REFS) + "\n")
    for mod, out in ((jtokenize, "j"), (tokenize_text, "t")):
        mod.main(["--input", str(tmp_path / "text"), "--output", str(tmp_path / out)] + args)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    make_corpus(root, n_train=4, n_valid=2)
    # one unreadable entry and one too short: stages 3 and 4 drop them
    with open(root / "train" / "wav.scp", "a") as f:
        f.write(f"train_bad {root / 'missing.wav'}\n")
    with open(root / "train" / "text", "a") as f:
        f.write("train_bad abc\n")
    return root


def test_pipeline_stages_1_to_5_are_byte_equal(data, tmp_path):
    args = ["--train_dir", str(data / "train"), "--valid_dir", str(data / "valid"),
            "--stage", "1", "--stop_stage", "5", "--min_samples", "8000"]
    jpipeline.main(args + ["--expdir", str(tmp_path / "j")])
    asr_pipeline.main(args + ["--expdir", str(tmp_path / "t")])
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                   if p.is_file())
    assert [str(f) for f in files] == [
        "data/train/text", "data/train/utt2num_samples", "data/train/wav.scp",
        "data/valid/text", "data/valid/utt2num_samples", "data/valid/wav.scp", "tokens.txt"]
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    assert "train_bad" not in (tmp_path / "t" / "data" / "train" / "wav.scp").read_text()


def _train_yaml(path):
    jconfig.dump_yaml({"frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 23},
                       "encoder_conf": ENC, "decoder_conf": DEC,
                       "model_conf": {"ctc_weight": 0.5}, "batch_type": "sorted",
                       "batch_size": 2, "max_epoch": 1, "keep_nbest_models": 1,
                       "speech_pad_multiple": 32000}, path)


def test_pipeline_stages_3_to_13_run_in_the_port(data, tmp_path):
    _train_yaml(tmp_path / "train.yaml")
    jconfig.dump_yaml({"lm_conf": {"embed_unit": 8, "att_unit": 16, "head": 2, "unit": 16,
                                   "layer": 1}, "max_epoch": 1, "keep_nbest_models": 1},
                      tmp_path / "lm.yaml")
    exp = tmp_path / "exp"
    result = asr_pipeline.main([
        "--config", str(tmp_path / "train.yaml"), "--train_dir", str(data / "train"),
        "--valid_dir", str(data / "valid"), "--expdir", str(exp), "--stage", "3",
        "--stop_stage", "13", "--device", "cpu", "--beam_size", "2", "--use_lm", "true",
        "--lm_config", str(tmp_path / "lm.yaml"), "--use_ngram", "true", "--ngram_order", "2"])
    assert result["metric"] == "CER" and result["n_utt"] == 2 and 0.0 <= result["err"]
    assert json.loads((exp / "score" / "valid" / "result.json").read_text()) == result
    assert (exp / "score" / "valid" / "result.txt").read_text().count("id: (") == 2
    assert np.isfinite(float((exp / "lm" / "perplexity_valid").read_text()))
    assert (exp / "ngram" / "2gram.arpa").read_text().startswith("\\data\\\nngram 1=")
    scores = read_2columns_text(exp / "decode" / "valid" / "1best_recog" / "score")
    assert sorted(scores) == ["valid_000", "valid_001"]
    assert all(np.isfinite(float(v)) for v in scores.values())
    assert "RTFx" in (exp / "decode" / "valid" / "rtf").read_text()
    assert (exp / "train" / "valid.loss.ave_1best.pth").is_file()


@pytest.mark.parametrize("flag, error, match", [
    (["--speed_perturb", "0.9,1.0,1.1"], NotImplementedError, "ROADMAP Queue 1 item 12"),
    (["--cmd_backend", "bogus"], ValueError, "unknown cmd backend"),
    (["--decode_nj", "0"], ValueError, "decode_nj"),
    (["--cmd_backend", "slurm", "--cmd_conf", "missing/slurm.conf"], FileNotFoundError,
     "slurm.conf")])
def test_pipeline_options_not_ported_raise(data, tmp_path, flag, error, match):
    """Stage 2 is not ported; a bad job option fails before any stage
    writes a file (stages 14-15 and the array jobs run since they were
    ported: tests/test_torch_recipe_io.py)."""
    with pytest.raises(error, match=match):
        asr_pipeline.main(["--train_dir", str(data / "train"), "--valid_dir",
                           str(data / "valid"), "--expdir", str(tmp_path)] + flag)
    assert not (tmp_path / "data").exists()


def test_ez_trainer_and_batched_inference(data, tmp_path):
    """ez.Trainer from in-memory data (collect_stats, 1 epoch), then the
    batched and the per-utterance CLI decodes of its directory agree on
    every text, and the asr_inference_new shim writes the same files."""
    tokens = ["<blank>", "<unk>", "a", "b", "c", "<sos/eos>"]
    (tmp_path / "tokens.txt").write_text("\n".join(tokens) + "\n")

    def split(name):
        wavs, texts = (read_2columns_text(data / name / f) for f in ("wav.scp", "text"))
        return {u: {"speech": read_audio(wavs[u])[1], "text": texts[u]} for u in texts
                if u != "train_bad"}

    cfg = {"token_list": str(tmp_path / "tokens.txt"), "device": "cpu",
           "frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 23},
           "encoder_conf": ENC, "decoder_conf": DEC, "batch_type": "sorted", "batch_size": 2,
           "max_epoch": 1, "keep_nbest_models": 1, "speech_pad_multiple": 32000}
    trainer = ez.Trainer("asr", cfg, split("train"), split("valid"), tmp_path / "exp")
    stats = trainer.collect_stats()
    assert trainer.config["normalize_conf"]["stats_file"] == str(stats)
    state = trainer.train()
    assert state.step == 2
    args = ["--asr_train_config", str(tmp_path / "exp" / "config.yaml"),
            "--asr_model_file", str(tmp_path / "exp" / "valid.loss.ave_1best.pth"),
            "--data_path_and_name_and_type", f"{data / 'valid' / 'wav.scp'},speech,sound",
            "--device", "cpu", "--beam_size", "3"]
    asr_inference.main(args + ["--output_dir", str(tmp_path / "one")])
    asr_inference.main(args + ["--output_dir", str(tmp_path / "batch"), "--batch_size", "2"])
    asr_inference_new.main(args + ["--output_dir", str(tmp_path / "new")])
    for d in ("batch", "new"):
        assert (tmp_path / d / "1best_recog" / "text").read_bytes() == \
            (tmp_path / "one" / "1best_recog" / "text").read_bytes(), d
    llm = str(Path(__file__).resolve().parent / "parity" / "tiny_llm_bytelevel")
    st_cfg = {**{k: v for k, v in cfg.items() if k != "token_list"}, "bpemodel": llm,
              "llm_conf": {"model_name_or_path": llm, "template_prompt": "fix ((HYP)) -> ",
                           "dtype": "float32"}}
    st = ez.Trainer("st", st_cfg, {}, {}, tmp_path)
    assert st.config["model"] == "llm_guided_st" and st.config["token_type"] == "hugging_face"
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        ez.Trainer("enh", cfg, {}, {}, tmp_path)
    shutil.rmtree(tmp_path / "exp")


def test_asr_task_main_options(data, tmp_path, capsys, caplog):
    """--print_config prints the resolved config as YAML (and writes
    nothing), a mistyped key is warned about, --dry_run writes config.yaml
    only, the mesh options raise before any file is written, and the
    device defaults to the card (no silent CPU fallback)."""
    from llm_guided_asr_tpu_torch.bin import asr_train
    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask, _batch_args
    from llm_guided_asr_tpu_torch.utils.config import loads_yaml

    _train_yaml(tmp_path / "train.yaml")
    base = ["--config", str(tmp_path / "train.yaml"), "--token_list", str(tmp_path / "t.txt"),
            "--output_dir", str(tmp_path / "exp")]
    (tmp_path / "t.txt").write_text("<blank>\n<unk>\na\nb\nc\n<sos/eos>\n")
    assert asr_train.main(base + ["--print_config", "--device", "cpu"]) is None
    printed = loads_yaml(capsys.readouterr().out)
    assert printed["encoder_conf"] == ENC and printed["device"] == "cpu"
    assert set(printed) >= set(ASRTask.get_default_config()) and "print_config" not in printed
    assert not (tmp_path / "exp").exists()
    with caplog.at_level("WARNING"):
        asr_train.main(base + ["--device", "cpu", "--dry_run", "true", "--encoder_cnf", "x"])
    assert "unknown config key 'encoder_cnf'" in caplog.text
    assert sorted(p.name for p in (tmp_path / "exp").iterdir()) == ["config.yaml"]
    for flag in (["--data_parallel", "2"], ["--model_parallel", "2"],
                 ["--sharded_optim", "true"]):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            asr_train.main(base + ["--output_dir", str(tmp_path / "mesh")] + flag)
    assert not (tmp_path / "mesh").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asr_train.main(base + ["--output_dir", str(tmp_path / "card")])
    cfg = {"train_data_path_and_name_and_type": [["w", "speech", "sound"], ["t", "text", "text"],
                                                 ["b", "bias_words", "text"],
                                                 ["c", "ctc_text", "text"]]}
    batch = {k: k for k in ("speech", "speech_lengths", "text", "text_lengths", "bias_words",
                            "bias_words_lengths", "ctc_text", "ctc_text_lengths", "_uids")}
    assert _batch_args(cfg)(batch) == {k: k for k in batch if k != "_uids"}


def test_speech2text_defaults(data, tmp_path):
    """From files the JAX defaults (ctc_weight 0.5, beam 10); from a model
    object the port's earlier ones (0.3, 10); a model object as the first
    argument is refused."""
    from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.tasks.asr import ASRTask, build_model
    from llm_guided_asr_tpu_torch.utils.config import dump_yaml, load_yaml

    _train_yaml(tmp_path / "train.yaml")
    (tmp_path / "t.txt").write_text("<blank>\n<unk>\na\nb\nc\n<sos/eos>\n")
    cfg = {**ASRTask.get_default_config(), **load_yaml(tmp_path / "train.yaml"),
           "token_list": str(tmp_path / "t.txt"), "normalize": "utterance_mvn"}
    dump_yaml(cfg, tmp_path / "config.yaml")
    s2t = Speech2Text(tmp_path / "config.yaml", device="cpu")
    assert (s2t.ctc_weight, s2t.beam_size, s2t.beam.ctc_weight) == (0.5, 10, 0.5)
    model = init_weights(build_model(cfg, "cpu"))
    mem = Speech2Text.from_model(model)
    assert (mem.ctc_weight, mem.beam_size, mem.tokenizer) == (0.3, 10, None)
    with pytest.raises(TypeError, match="from_model"):
        Speech2Text(model)
    (text, tokens, ids, hyp), = s2t(read_audio(str(data / "valid" / "valid_000.wav"))[1])
    assert text == "".join(tokens).replace("<space>", " ") and len(ids) == len(tokens)
