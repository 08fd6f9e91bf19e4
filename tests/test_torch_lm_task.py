"""Port vs JAX, the LM task: ``LMTask.main`` for one epoch of a tiny
Transformer LM from the same weights (the JAX init's, carried into the
port's seeded init by a stand-in for ``convert.init_weights``), every
reporter.json stat within rtol 1e-5 (one Adam update); ``calc_perplexity``
of JAX's checkpoint in both packages and of each package's own checkpoint
within rtol 1e-5; the ``lm_calc_perplexity`` and ``lm_train`` CLIs, and
``train --task lm``."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from llm_guided_asr_tpu.tasks import lm as jlm_task
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch import convert
from llm_guided_asr_tpu_torch.bin import lm_calc_perplexity, lm_train, train
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.tasks import lm as tlm_task

TOKENS = ["<blank>", "<unk>", "a", "b", "c", "d", "<sos/eos>"]
TIME_KEYS = {"time", "iter_time", "grad_time", "optim_step_time", "train_step_time"}


@pytest.fixture(scope="module")
def lm_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    rng = np.random.default_rng(0)
    for split, n in (("train", 12), ("valid", 5)):
        lines = ["".join(rng.choice(list("abcd")) for _ in range(rng.integers(2, 9)))
                 for _ in range(n)]
        (root / f"{split}.txt").write_text("".join(f"{split}{i} {t}\n"
                                                  for i, t in enumerate(lines)))
    (root / "tokens.txt").write_text("\n".join(TOKENS) + "\n")
    config = {
        "token_list": str(root / "tokens.txt"),
        "lm": "transformer",
        "lm_conf": {"embed_unit": 16, "att_unit": 32, "head": 2, "unit": 48, "layer": 2,
                    "dropout_rate": 0.0},
        "optim_conf": {"lr": 0.01},
        "scheduler_conf": {"warmup_steps": 2},
        "max_epoch": 1,
        "keep_nbest_models": 1,
        "log_interval": 1,
        "train_data_path_and_name_and_type": [[str(root / "train.txt"), "text", "text"]],
        "valid_data_path_and_name_and_type": [[str(root / "valid.txt"), "text", "text"]],
    }
    jconfig.dump_yaml(config, root / "lm.yaml")
    jlm_task.LMTask.main(["--config", str(root / "lm.yaml"), "--output_dir", str(root / "jexp")])
    full = {**jlm_task.LMTask.get_default_config(), **config}
    init = jlm_task.init_lm_variables(jlm_task.build_lm(full), 0)
    return root, params_from_jax(jax.tree_util.tree_map(np.asarray, dict(init)))


def _stats(out: Path):
    stats = json.loads((out / "reporter.json").read_text())["stats"]
    return {e: {ph: {k: v for k, v in s.items() if k not in TIME_KEYS} for ph, s in p.items()}
            for e, p in stats.items()}


@pytest.fixture(scope="module")
def port_lm(lm_corpus):
    root, init = lm_corpus

    def jax_init(model, seed=0):  # the port's seeded init -> the JAX init's weights
        model.load_state_dict(init, strict=True)
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "init_weights", jax_init)
        state = lm_train.main(["--config", str(root / "lm.yaml"), "--output_dir",
                               str(root / "texp"), "--device", "cpu"])
    return state


def test_lm_task_main_matches_jax(lm_corpus, port_lm):
    root, _ = lm_corpus
    assert port_lm.step == 1
    got, want = _stats(root / "texp"), _stats(root / "jexp")
    assert got.keys() == want.keys() == {"1"}
    for ph in ("train", "valid"):
        assert got["1"][ph].keys() == want["1"][ph].keys()
        for k, v in got["1"][ph].items():
            np.testing.assert_allclose(v, want["1"][ph][k], rtol=1e-5, err_msg=f"{ph} {k}")


def test_calc_perplexity_matches_jax(lm_corpus, port_lm, tmp_path):
    root, _ = lm_corpus
    data = [(str(root / "valid.txt"), "text", "text")]
    j_ave = root / "jexp" / "valid.loss.ave_1best.msgpack"
    want = jlm_task.calc_perplexity(root / "jexp" / "config.yaml", j_ave, data, batch_size=2)
    got = tlm_task.calc_perplexity(root / "jexp" / "config.yaml", j_ave, data, batch_size=2,
                                   device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    own = lm_calc_perplexity.main([
        "--train_config", str(root / "texp" / "config.yaml"),
        "--model_file", str(root / "texp" / "valid.loss.ave_1best.pth"),
        "--data_path_and_name_and_type", f"{root / 'valid.txt'},text,text",
        "--output_dir", str(tmp_path), "--device", "cpu"])
    np.testing.assert_allclose(own, want, rtol=1e-5)
    assert float((tmp_path / "perplexity").read_text()) == own


def test_train_cli_dispatches_by_task(lm_corpus, tmp_path):
    root, _ = lm_corpus
    assert train.main(["--task", "lm", "--config", str(root / "lm.yaml"), "--output_dir",
                       str(tmp_path), "--device", "cpu", "--dry_run", "true"]) is None
    assert (tmp_path / "config.yaml").is_file()
    # --task st reaches the ST task (ported): a dry run writes its config
    llm = str(Path(__file__).resolve().parent / "parity" / "tiny_llm_bytelevel")
    st_dir = tmp_path / "st"
    assert train.main(["--task", "st", "--device", "cpu", "--dry_run", "true", "--output_dir",
                       str(st_dir), "--llm_conf", json.dumps({"model_name_or_path": llm})]) is None
    assert "model: llm_guided_st" in (st_dir / "config.yaml").read_text()
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        train.main(["--task", "enh"])
