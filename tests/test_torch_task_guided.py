"""Port vs JAX, the ASR task layer's builders and the guided model's
experiment directory (see test_torch_task.py for the corpus):

- ``build_model_config`` field by field for the tiny CTC/attention config,
  the guided config over tests/parity/tiny_llm_bpe and an RWKV transducer
  config; the JAX choices the port lacks raise, naming their ROADMAP item;
- the port's ``asr_inference`` on a JAX-written guided directory
  (ASRTask.main --dry_run's config.yaml, the JAX init's variables without
  the LLM) writes JAX ``inference``'s text and token files byte for byte,
  scores within 1e-4, at beam 4;
- ``params_from_msgpack`` equals ``params_from_jax`` of flax's
  ``msgpack_restore`` on that file and on a bfloat16 tree, and refuses a
  collection it has no home for."""

from pathlib import Path

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_inference as jinference
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu.train.checkpoint import save_pytree
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch.bin import asr_inference as tinference
from llm_guided_asr_tpu_torch.convert import params_from_jax, params_from_msgpack
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from test_torch_task import ENC, _compare_decodes, _guided, _tiny, corpus  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_guided(corpus):
    """A JAX-written guided experiment directory: ASRTask.main --dry_run's
    config.yaml and the JAX init's variables (the LLM left out), decoded by
    JAX inference."""
    root = corpus
    out = root / "jguided"
    jasr.ASRTask.main(["--config", str(root / "guided.yaml"), "--dry_run", "true",
                       "--output_dir", str(out)])
    config = {**jasr.ASRTask.get_default_config(), **jconfig.load_yaml(out / "config.yaml")}
    model = jasr.build_model(config)
    variables = jasr.init_model_variables(model, config, 3)
    save_pytree(out / "init.msgpack", variables, exclude_prefixes=("params/llm",))
    jinference.inference(str(root / "jgdec"), [(str(root / "valid" / "wav.scp"), "speech",
                                                "sound")],
                         str(out / "config.yaml"), str(out / "init.msgpack"), beam_size=4,
                         maxlenratio=0.5)
    return out


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _same_fields(port_cfg, jax_cfg, where=""):
    """Every field of the port's dataclass equals the JAX one's (nested
    dataclasses field by field)."""
    for name, value in _fields(port_cfg).items():
        if name == "input_size" and not hasattr(jax_cfg, name):
            continue  # the port's feature width without a frontend (JAX reads its input)
        want = getattr(jax_cfg, name)
        if hasattr(value, "__dataclass_fields__"):
            _same_fields(value, want, f"{where}{name}.")
        else:
            assert value == want, f"{where}{name}: {value!r} != {want!r}"


def test_build_model_config_matches_jax(corpus):
    root = corpus
    tiny = {**jasr.ASRTask.get_default_config(), **_tiny(root)}
    _same_fields(tasr.build_model_config(tiny), jasr.build_model_config(tiny))
    guided = {**jasr.ASRTask.get_default_config(), **_guided(root)}
    _same_fields(tasr.build_model(guided, "cpu").cfg, jasr.build_model(guided).cfg)
    transducer = {**tiny, "model": "transducer", "specaug": "specaug",
                  "specaug_conf": {"num_time_mask": 1, "time_mask_width_range": [0, 5]},
                  "decoder_conf": {"decoder_type": "rwkv", "embed_size": 16, "hidden_size": 16,
                                   "num_layers": 2},
                  "model_conf": {"joint_size": 24, "aux_ctc_weight": 0.2}}
    _same_fields(tasr.build_transducer_config(transducer), jasr.build_model(transducer).cfg)
    # a JAX choice the port lacks raises, naming its ROADMAP item
    for bad in ({"model": "maskctc"}, {"encoder_conf": {**ENC, "rel_pos_type": "legacy"}},
                {"train_dtype": "bfloat16"}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            tasr.build_model({**tiny, **bad}, "cpu")
    # the multichannel fields and AV-HuBERT, once refused, give JAX's config
    for good in ({"encoder": "avhubert"}, {"frontend_conf": {"use_wpe": True}},
                 {"frontend_conf": {"use_beamformer": True, "mask_units": 16}}):
        _same_fields(tasr.build_model_config({**tiny, **good}),
                     jasr.build_model_config({**tiny, **good}))


def test_port_decodes_the_jax_guided_directory(corpus, jax_guided):
    root = corpus
    tinference.main([
        "--asr_train_config", str(jax_guided / "config.yaml"),
        "--asr_model_file", str(jax_guided / "init.msgpack"),
        "--data_path_and_name_and_type", f"{root / 'valid' / 'wav.scp'},speech,sound",
        "--output_dir", str(root / "tgdec"), "--device", "cpu", "--beam_size", "4",
        "--maxlenratio", "0.5"])
    _compare_decodes(root / "tgdec", root / "jgdec")


def test_params_from_msgpack_matches_flax_with_bf16(jax_guided, tmp_path):
    rng = np.random.default_rng(0)
    bf16 = {"params": {"dense": {"kernel": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
                                 "bias": jnp.zeros((3,), jnp.bfloat16)}},
            "mvn": {"mean": np.zeros(4, np.float32), "inv_std": np.ones(4, np.float32)}}
    save_pytree(tmp_path / "bf16.msgpack", bf16)
    for path in (jax_guided / "init.msgpack", tmp_path / "bf16.msgpack"):
        got = params_from_msgpack(path)
        want = params_from_jax(flax.serialization.msgpack_restore(Path(path).read_bytes()))
        assert got.keys() == want.keys(), path
        for k in got:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (path, k)
    save_pytree(tmp_path / "odd.msgpack", {"params": {}, "cache": {"x": np.zeros(2)}})
    with pytest.raises(KeyError, match="cache"):
        params_from_msgpack(tmp_path / "odd.msgpack")
