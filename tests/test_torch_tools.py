"""Port vs JAX, the small tools: ``lm_inference``'s greedy continuation
token for token from one JAX-written LM directory (sampling: the same
seed draws the same text, which cannot equal JAX's ``jax.random`` draws);
``aggregate_stats_dirs``' byte-equal outputs; the exported vocabulary
line-equal to JAX's ``AutoTokenizer`` export on every committed
``tests/parity/tiny_llm_*`` tokenizer; the native edit distance equal to
the Python one on random pairs; ops/augment.py equal to JAX's; the
pipeline's stage 2 writing JAX's perturbed wavs byte for byte and a later
run reusing them; and the ``asr_transducer_train`` shim."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import aggregate_stats_dirs as jaggregate
from llm_guided_asr_tpu.bin import asr_pipeline as jpipeline
from llm_guided_asr_tpu.bin import hugging_face_export_vocabulary as jexport
from llm_guided_asr_tpu.bin import lm_inference as jlm_inference
from llm_guided_asr_tpu.ops import augment as jaug
from llm_guided_asr_tpu.tasks import lm as jlm_task
from llm_guided_asr_tpu.train.checkpoint import save_pytree
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch.bin import aggregate_stats_dirs, asr_pipeline, asr_transducer_train
from llm_guided_asr_tpu_torch.bin import hugging_face_export_vocabulary, lm_inference
from llm_guided_asr_tpu_torch.ops import augment as taug
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from llm_guided_asr_tpu_torch.utils import metrics
from test_torch_task import make_corpus
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

PARITY = Path(__file__).resolve().parent / "parity"
LM_TOKENS = ["<blank>", "<unk>", "<space>"] + list("abcde") + ["<sos/eos>"]


def _fast_lm_init(model, seed=0):
    """Stand-in for JAX's eager ``init_lm_variables``: zeros of the shapes,
    which the .msgpack replaces leaf for leaf."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32),
                            jnp.array([4], jnp.int32))
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    (root / "tokens.txt").write_text("\n".join(LM_TOKENS) + "\n")
    config = {**jlm_task.LMTask.get_default_config(), "token_type": "char",
              "token_list": str(root / "tokens.txt"),
              "lm_conf": {"embed_unit": 8, "att_unit": 16, "head": 2, "unit": 16, "layer": 1,
                          "dropout_rate": 0.0}}
    jconfig.dump_yaml(config, root / "config.yaml")
    model = jlm_task.build_lm(config)
    variables = seeded_variables(model, jnp.zeros((1, 4), jnp.int32), jnp.array([4], jnp.int32),
                                 seed=3)
    save_pytree(root / "lm.msgpack", variables)
    (root / "prompts").write_text("p1 abc\np2 e d\np3 a\n")
    return root


def _lm_args(root, **kw):
    return dict(text=str(root / "prompts"), train_config=str(root / "config.yaml"),
                model_file=str(root / "lm.msgpack"), n_new=8, **kw)


def test_lm_inference_greedy_matches_jax(lm_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(jlm_task, "init_lm_variables", _fast_lm_init)
    jlm_inference.inference(str(tmp_path / "j"), **_lm_args(lm_dir))
    got = lm_inference.main([x for k, v in _lm_args(lm_dir).items() for x in (f"--{k}", str(v))]
                            + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert (tmp_path / "t" / "text").read_text() == (tmp_path / "j" / "text").read_text()
    assert sorted(got) == ["p1", "p2", "p3"] and any(got.values())


def test_lm_inference_samples_from_its_seed(lm_dir, tmp_path):
    runs = [lm_inference.inference(str(tmp_path / f"s{i}"),
                                   **_lm_args(lm_dir, temperature=2.0, seed=seed), device="cpu")
            for i, seed in enumerate((4, 4, 5))]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert (tmp_path / "s0" / "text").read_bytes() == (tmp_path / "s1" / "text").read_bytes()


def test_aggregate_stats_dirs_is_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    dirs = []
    for j in range(3):
        for split in ("train", "valid"):
            d = tmp_path / f"stats.{j}" / split
            d.mkdir(parents=True)
            feats = rng.standard_normal((5 + j, 4))
            np.savez(d / "feats_stats.npz", count=len(feats), sum=feats.sum(0),
                     sum_square=(feats ** 2).sum(0))
            (d / "speech_shape").write_text(f"{split}{j}a {100 + j}\n{split}{j}b {90 + j}\n")
            (d / "text_shape").write_text(f"{split}{j}a {3 + j}\n")
        dirs.append(str(tmp_path / f"stats.{j}"))
    jaggregate.aggregate(dirs, str(tmp_path / "j"))
    aggregate_stats_dirs.main(["--input_dir", "[" + ", ".join(dirs) + "]",
                               "--output_dir", str(tmp_path / "t")])
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                   if p.is_file())
    assert len(files) == 6
    assert files == sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("name", sorted(p.name for p in PARITY.glob("tiny_llm_*")))
def test_exported_vocabulary_matches_jax(tmp_path, name):
    jexport.export_vocabulary(str(PARITY / name), str(tmp_path / "j.txt"))
    size = hugging_face_export_vocabulary.main(["--model_name_or_path", str(PARITY / name),
                                                "--output", str(tmp_path / "t.txt")])
    want = (tmp_path / "j.txt").read_text(encoding="utf-8").split("\n")
    assert (tmp_path / "t.txt").read_text(encoding="utf-8").split("\n") == want
    assert size == len(want) - 1


def test_native_edit_distance_equals_python():
    rng = np.random.default_rng(0)
    for _ in range(300):
        ref, hyp = (list(rng.choice(list("abcd"), size=rng.integers(0, 15))) for _ in range(2))
        assert metrics.edit_distance(ref, hyp) == metrics.edit_distance_py(ref, hyp)
    words = "the cat sat on the mat".split()
    assert metrics.edit_distance(words, words[::-1]) == metrics.edit_distance_py(words,
                                                                                  words[::-1])
    assert metrics.native_lib().edit_distance_i64 is not None


def test_augment_matches_jax():
    rng = np.random.default_rng(1)
    wav = rng.standard_normal(1001).astype(np.float32)
    for f in (0.9, 1.0, 1.1, 1.37):
        np.testing.assert_array_equal(taug.speed_perturb(wav, f), jaug.speed_perturb(wav, f))
    rir = rng.standard_normal(33).astype(np.float32)
    np.testing.assert_array_equal(taug.apply_rir(wav, rir), jaug.apply_rir(wav, rir))
    noise = rng.standard_normal(400).astype(np.float32)
    np.testing.assert_array_equal(taug.add_noise(wav, noise, 10.0, np.random.default_rng(2)),
                                  jaug.add_noise(wav, noise, 10.0, np.random.default_rng(2)))
    pairs = [("u1", wav), ("u2", wav[:500])]
    got, want = taug.perturb_dataset_speeds(pairs), jaug.perturb_dataset_speeds(pairs)
    assert [u for u, _ in got] == [u for u, _ in want] == ["sp0.9-u1", "u1", "sp1.1-u1",
                                                           "sp0.9-u2", "u2", "sp1.1-u2"]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    t_aug = taug.SpeedPerturbPreprocessor(taug.WavAugPreprocessor(
        rirs=[rir], noises=[noise], seed=3), seed=4)
    j_aug = jaug.SpeedPerturbPreprocessor(jaug.WavAugPreprocessor(
        rirs=[rir], noises=[noise], seed=3), seed=4)
    for i in range(4):
        g, w = t_aug(f"u{i}", {"speech": wav}), j_aug(f"u{i}", {"speech": wav})
        np.testing.assert_array_equal(g["speech"], w["speech"])


def test_pipeline_stage2_writes_jax_s_perturbed_wavs_and_reuses_them(tmp_path):
    data = tmp_path / "data"
    make_corpus(data, n_train=2, n_valid=1)
    args = ["--train_dir", str(data / "train"), "--valid_dir", str(data / "valid"),
            "--speed_perturb", "0.9,1.0,1.1"]
    jpipeline.main(args + ["--stage", "1", "--stop_stage", "2", "--expdir", str(tmp_path / "j")])
    asr_pipeline.main(args + ["--stage", "1", "--stop_stage", "2",
                              "--expdir", str(tmp_path / "t")])
    sp = Path("data") / "train_sp"
    names = sorted(p.name for p in (tmp_path / "j" / sp).iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t" / sp).iterdir())
    assert len([n for n in names if n.endswith(".wav")]) == 4
    for name in names:
        got = (tmp_path / "t" / sp / name).read_bytes()
        want = (tmp_path / "j" / sp / name).read_bytes()
        if name.endswith(".wav"):
            assert got == want, name
        else:  # the paths of the copies name each run's expdir
            assert got == want.replace(str(tmp_path / "j").encode(), str(tmp_path / "t").encode())
    # a later run that starts past stage 2 trains on the perturbed split
    asr_pipeline.main(args + ["--stage", "3", "--stop_stage", "3",
                              "--expdir", str(tmp_path / "t")])
    ids = [ln.split()[0] for ln in (tmp_path / "t" / "data" / "train" / "wav.scp")
           .read_text().splitlines()]
    assert sorted(ids) == sorted(ln.split()[0] for ln in (tmp_path / "t" / sp / "wav.scp")
                                 .read_text().splitlines())
    assert sum(i.startswith("sp0.9-") for i in ids) == 2


def test_asr_transducer_train_runs_asr_task_as_a_transducer(monkeypatch):
    seen = []
    monkeypatch.setattr(tasr.ASRTask, "main", classmethod(lambda cls, cmd: seen.append(cmd)))
    asr_transducer_train.main(["--config", "t.yaml", "--device", "cpu"])
    assert seen == [["--model", "transducer", "--config", "t.yaml", "--device", "cpu"]]
