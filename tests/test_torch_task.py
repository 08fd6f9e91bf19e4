"""Port vs JAX, the ASR task layer (tasks/asr.py and the CLIs over it).

On the tone corpus of tests/test_e2e_tiny.py (4 + 2 utterances of 3 or 4
characters: two lengths, so that JAX compiles its frontend twice) at tiny
widths, all on the CPU (``--device cpu`` for the port):

- ``collect_stats``: equal shape files, feats_stats.npz within rtol 1e-5;
- JAX ``ASRTask.main`` and the port's train 2 epochs from the same weights
  (dropout 0, SpecAug off, one ``init_param`` msgpack written by JAX, the
  JAX package's stats file): every reporter.json stat per epoch within
  rtol 2e-4, tests/test_torch_trainer_run.py's tolerance;
- the port's ``asr_inference`` on the JAX package's experiment directory
  (its config.yaml and .msgpack; ``device: null`` there, ``--device cpu``
  on the command line) writes JAX ``inference``'s 1best_recog text and
  token files byte for byte, scores within 1e-4;
- ``params_from_msgpack`` equals ``params_from_jax`` of flax's
  ``msgpack_restore`` on those files.

The JAX runs happen once, in a module fixture; the guided model, the
config builders and a bfloat16 tree are in test_torch_task_guided.py."""

import contextlib
import functools
import json
from pathlib import Path

import flax.linen
import flax.serialization
import jax
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_inference as jinference
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu.train.checkpoint import save_pytree
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch.bin import asr_inference as tinference
from llm_guided_asr_tpu_torch.bin import asr_train
from llm_guided_asr_tpu_torch.convert import params_from_jax, params_from_msgpack
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from llm_guided_asr_tpu.data.fileio import write_wav
from test_e2e_tiny import SR, TOKEN_LIST, TONES, synth
from test_torch_train import jit

torch.set_num_threads(1)

TIME_KEYS = {"time", "iter_time", "grad_time", "optim_step_time", "train_step_time"}
BPE_DIR = str(Path(__file__).resolve().parent / "parity" / "tiny_llm_bpe")
# one block each: the task layer is about wiring, not depth, and XLA
# compiles each JAX step in about half the time of two blocks
ENC = {"output_size": 32, "attention_heads": 2, "linear_units": 64, "num_blocks": 1,
       "macaron_style": True, "use_cnn_module": True, "cnn_module_kernel": 7,
       "dropout_rate": 0.0, "positional_dropout_rate": 0.0, "attention_dropout_rate": 0.0}
DEC = {"attention_heads": 2, "linear_units": 64, "num_blocks": 1, "dropout_rate": 0.0,
       "positional_dropout_rate": 0.0}


def _tiny(root: Path) -> dict:
    return {
        "token_type": "char",
        "token_list": str(root / "tokens.txt"),
        "frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 23},
        "normalize": "global_mvn",
        "encoder": "conformer",
        "encoder_conf": ENC,
        "decoder_conf": DEC,
        "model_conf": {"ctc_weight": 0.5, "lsm_weight": 0.1},
        "optim": "adam",
        "optim_conf": {"lr": 0.003},
        "scheduler": "warmuplr",
        "scheduler_conf": {"warmup_steps": 6},
        "batch_type": "sorted",
        "batch_size": 2,
        "max_epoch": 2,
        "keep_nbest_models": 2,
        "log_interval": 1,
        "speech_pad_multiple": 32000,  # one padded shape: few JAX compiles
        "text_pad_multiple": 8,
        "train_data_path_and_name_and_type": [
            [str(root / "train" / "wav.scp"), "speech", "sound"],
            [str(root / "train" / "text"), "text", "text"]],
        "valid_data_path_and_name_and_type": [
            [str(root / "valid" / "wav.scp"), "speech", "sound"],
            [str(root / "valid" / "text"), "text", "text"]],
    }


def _guided(root: Path) -> dict:
    return {**_tiny(root), "model": "llm_guided_asr", "llm": "llama",
            "llm_conf": {"model_name_or_path": BPE_DIR, "template_prompt": 'fix "((HYP))" -> "',
                         "dtype": "float32", "pad_token": "<pad>"},
            "token_type": "hugging_face", "token_list": None, "normalize": "utterance_mvn",
            "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1}}


def make_corpus(root: Path, n_train: int = 4, n_valid: int = 2, seed: int = 0):
    """test_e2e_tiny.make_corpus with texts of 3 or 4 characters."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("valid", n_valid)):
        d = root / split
        d.mkdir(parents=True)
        with open(d / "wav.scp", "w") as wscp, open(d / "text", "w") as tf:
            for i in range(n):
                text = "".join(rng.choice(list(TONES)) for _ in range(3 + i % 2))
                uid = f"{split}_{i:03d}"
                write_wav(d / f"{uid}.wav", SR, synth(text, rng))
                wscp.write(f"{uid} {d / f'{uid}.wav'}\n")
                tf.write(f"{uid} {text}\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tone")
    make_corpus(root)
    (root / "tokens.txt").write_text("\n".join(TOKEN_LIST) + "\n")
    jconfig.dump_yaml(_tiny(root), root / "train.yaml")
    jconfig.dump_yaml(_guided(root), root / "guided.yaml")
    return root


_EAGER_INIT = flax.linen.Module.init


def _jit_init(self, rngs, *args, **kwargs):
    """flax's init under jax.jit: JAX's task layer (init_model_variables)
    runs it eagerly, ~20 s for the tiny model on one CPU thread, and jit
    gives the same variables in a few seconds."""
    return jit(functools.partial(_EAGER_INIT, self, **kwargs))(rngs, *args)


@contextlib.contextmanager
def jit_flax_init():
    """A context in which every flax init of the JAX package is jitted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", _jit_init)
        yield


@pytest.fixture(scope="module")
def jax_exp(corpus):
    """JAX: collect_stats, one seeded init written as a params msgpack, two
    epochs of ASRTask.main from it, and a decode of the valid split (each
    flax init jitted)."""
    with jit_flax_init():
        return _jax_exp(corpus)


def _jax_exp(corpus):
    root = corpus
    jasr.ASRTask.main(["--config", str(root / "train.yaml"), "--collect_stats", "true",
                       "--output_dir", str(root / "jstats")])
    stats = root / "jstats" / "train" / "feats_stats.npz"
    config = {**jasr.ASRTask.get_default_config(), **_tiny(root),
              "normalize_conf": {"stats_file": str(stats)}}
    variables = jasr.init_model_variables(jasr.build_model(config), config, 0)
    save_pytree(root / "init.msgpack", {"params": variables["params"]})
    common = ["--config", str(root / "train.yaml"), "--normalize_conf", f"stats_file={stats}",
              "--init_param", json.dumps([str(root / "init.msgpack")])]
    jasr.ASRTask.main(common + ["--output_dir", str(root / "jexp")])
    model_file = root / "jexp" / "valid.loss.ave_2best.msgpack"
    jinference.inference(str(root / "jdec"), [(str(root / "valid" / "wav.scp"), "speech",
                                               "sound")],
                         str(root / "jexp" / "config.yaml"), str(model_file))
    return {"stats": stats, "common": common, "model_file": model_file}


def test_collect_stats_matches_jax(corpus, jax_exp):
    root = corpus
    asr_train.main(["--config", str(root / "train.yaml"), "--collect_stats", "true",
                    "--output_dir", str(root / "tstats"), "--device", "cpu"])
    for split in ("train", "valid"):
        for name in ("speech_shape", "text_shape"):
            assert (root / "tstats" / split / name).read_bytes() == \
                (root / "jstats" / split / name).read_bytes(), (split, name)
        got = np.load(root / "tstats" / split / "feats_stats.npz")
        want = np.load(root / "jstats" / split / "feats_stats.npz")
        assert int(got["count"]) == int(want["count"])
        for k in ("sum", "sum_square"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{split} {k}")


def _stats(out: Path):
    stats = json.loads((out / "reporter.json").read_text())["stats"]
    return {e: {ph: {k: v for k, v in s.items() if k not in TIME_KEYS} for ph, s in p.items()}
            for e, p in stats.items()}


def test_asr_task_main_matches_jax_epoch_by_epoch(corpus, jax_exp):
    root = corpus
    state = asr_train.main(jax_exp["common"] + ["--output_dir", str(root / "texp"),
                                                "--device", "cpu"])
    assert state.step == 4  # 2 epochs of 2 batches
    got, want = _stats(root / "texp"), _stats(root / "jexp")
    assert got.keys() == want.keys() == {"1", "2"}
    for e in got:
        for ph in ("train", "valid"):
            assert got[e][ph].keys() == want[e][ph].keys(), (e, ph)
            for k, v in got[e][ph].items():
                np.testing.assert_allclose(v, want[e][ph][k], rtol=2e-4, err_msg=f"{e} {ph} {k}")
    assert sorted(p.name for p in (root / "texp").glob("*.pth")) == [
        "1epoch.pth", "2epoch.pth", "checkpoint.pth", "latest.pth", "valid.loss.ave_2best.pth",
        "valid.loss.best.pth"]
    # the port's config.yaml reads back in the JAX package as the port wrote it
    assert jconfig.load_yaml(root / "texp" / "config.yaml")["init_param"] == \
        [str(root / "init.msgpack")]


def assert_float32_checkpoint(path: Path):
    """Every floating tensor of a checkpoint (weights and optimizer state)
    is float32."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    tensors = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(ckpt)
    floats = {t.dtype for t in tensors if t.is_floating_point()}
    assert floats == {torch.float32}, floats
    return ckpt


def test_asr_task_trains_the_model_in_bf16(corpus, jax_exp):
    """``--train_dtype bfloat16`` through the port's ASRTask.main (one
    epoch of the tiny CTC/attention model, the JAX package's stats file):
    finite losses, and the weights and the Adam state in float32 in every
    checkpoint, as JAX saves them."""
    root = corpus
    out = root / "texp_bf16"
    state = asr_train.main(["--config", str(root / "train.yaml"), "--normalize_conf",
                            f"stats_file={jax_exp['stats']}", "--train_dtype", "bfloat16",
                            "--max_epoch", "1", "--output_dir", str(out), "--device", "cpu"])
    assert state.step == 2
    stats = json.loads((out / "reporter.json").read_text())["stats"]["1"]
    assert all(np.isfinite(v) for ph in ("train", "valid") for v in stats[ph].values())
    ckpt = assert_float32_checkpoint(out / "checkpoint.pth")
    assert ckpt["optimizer"]["state"]
    assert_float32_checkpoint(out / "1epoch.pth")


def _compare_decodes(got: Path, want: Path):
    for name in ("text", "token"):
        assert (got / "1best_recog" / name).read_bytes() == \
            (want / "1best_recog" / name).read_bytes(), name
    names = sorted(p.name for p in (want / "1best_recog").iterdir())
    assert sorted(p.name for p in (got / "1best_recog").iterdir()) == names
    for name in names:
        if name.startswith("score"):
            g = {k: float(v) for k, v in (l.split() for l in
                                          (got / "1best_recog" / name).read_text().splitlines())}
            w = {k: float(v) for k, v in (l.split() for l in
                                          (want / "1best_recog" / name).read_text().splitlines())}
            assert g.keys() == w.keys()
            for k in g:
                assert abs(g[k] - w[k]) <= 1e-4, (name, k, g[k], w[k])
    assert (got / "rtf").read_text().startswith("decode_s ")


def test_port_decodes_the_jax_experiment_directory(corpus, jax_exp):
    root = corpus
    s2t = tinference.main([
        "--asr_train_config", str(root / "jexp" / "config.yaml"),
        "--asr_model_file", str(jax_exp["model_file"]),
        "--data_path_and_name_and_type", f"{root / 'valid' / 'wav.scp'},speech,sound",
        "--output_dir", str(root / "tdec"), "--device", "cpu"])
    assert (s2t.ctc_weight, s2t.beam_size) == (0.5, 10)  # the JAX defaults
    _compare_decodes(root / "tdec", root / "jdec")
    # every tensor of the msgpack found its home; nothing of the model is missing
    model = tasr.ASRTask.build_model_from_file(root / "jexp" / "config.yaml", None, "cpu")[0]
    assert tasr.load_model_file(model, jax_exp["model_file"]) == []


def test_params_from_msgpack_matches_flax(corpus, jax_exp):
    for path in (jax_exp["model_file"], corpus / "jexp" / "1epoch.msgpack"):
        got = params_from_msgpack(path)
        want = params_from_jax(flax.serialization.msgpack_restore(Path(path).read_bytes()))
        assert got.keys() == want.keys(), path
        for k in got:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (path, k)
