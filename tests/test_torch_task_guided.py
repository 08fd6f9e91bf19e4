"""Port vs JAX, the ASR task layer's builders and the guided model's
experiment directory (see test_torch_task.py for the corpus):

- ``build_model_config`` field by field for the tiny CTC/attention config,
  the guided config over tests/parity/tiny_llm_bpe and an RWKV transducer
  config, also under ``rel_pos_type: legacy``, ``context_size`` and
  bfloat16 (``train_dtype``, ``use_amp``); the JAX choices the port lacks
  raise, naming their ROADMAP item;
- a JAX-written ``train_dtype: bfloat16`` directory served in float32 by
  default (JAX's files) and in bfloat16 on request;
- the port's ``asr_inference`` on a JAX-written guided directory
  (ASRTask.main --dry_run's config.yaml, the JAX init's variables without
  the LLM) writes JAX ``inference``'s text and token files byte for byte,
  scores within 1e-4, at beam 4;
- ``params_from_msgpack`` equals ``params_from_jax`` of flax's
  ``msgpack_restore`` on that file and on a bfloat16 tree, and refuses a
  collection it has no home for."""

import json
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
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
from test_torch_task import (  # noqa: F401
    ENC,
    _compare_decodes,
    assert_float32_checkpoint,
    _guided,
    _tiny,
    corpus,
    jit_flax_init,
)
from test_torch_train import jit

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_guided(corpus):
    """A JAX-written guided experiment directory: ASRTask.main --dry_run's
    config.yaml and the JAX init's variables (the LLM left out), decoded by
    JAX inference (each flax init jitted)."""
    with jit_flax_init():
        return _jax_guided(corpus)


def _jax_guided(corpus):
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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        tasr.build_model({**tiny, "model": "maskctc"}, "cpu")
    # the multichannel fields, AV-HuBERT, the legacy rel-pos encoding (JAX
    # builds the latest whatever rel_pos_type says) and the transducer's
    # context_size (JAX never reads it), once refused, give JAX's config
    for good in ({"encoder": "avhubert"}, {"frontend_conf": {"use_wpe": True}},
                 {"frontend_conf": {"use_beamformer": True, "mask_units": 16}},
                 {"encoder_conf": {**ENC, "rel_pos_type": "legacy"}}):
        _same_fields(tasr.build_model_config({**tiny, **good}),
                     jasr.build_model_config({**tiny, **good}))
    _same_fields(tasr.build_transducer_config(
        {**transducer, "decoder_conf": {**transducer["decoder_conf"], "context_size": 2}}),
        jasr.build_model(transducer).cfg)
    # bfloat16 compute (train_dtype or use_amp), once refused: JAX's config
    # and dtype, parameters float32
    for conf, amp in ((tiny, {"train_dtype": "bfloat16"}), (tiny, {"train_dtype": "bf16"}),
                      (guided, {"use_amp": True})):
        tm, jm = tasr.build_model({**conf, **amp}, "cpu"), jasr.build_model({**conf, **amp})
        _same_fields(tm.cfg, jm.cfg)
        assert tm.compute.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
        assert all(p.dtype == torch.float32 for n, p in tm.named_parameters()
                   if not n.startswith("llm."))


def test_asr_task_trains_the_guided_model_with_use_amp(corpus):
    """``--use_amp true`` through the port's ASRTask.main: one epoch of
    the guided model (phase 2's LLM frozen and out of the files) in
    bfloat16, finite losses, every checkpoint's tensors float32."""
    root = corpus
    out = root / "tguided_amp"
    state = asr_train.main(["--config", str(root / "guided.yaml"), "--use_amp", "true",
                            "--max_epoch", "1", "--output_dir", str(out), "--device", "cpu"])
    assert state.step == 2
    stats = json.loads((out / "reporter.json").read_text())["stats"]["1"]
    assert all(np.isfinite(v) for ph in ("train", "valid") for v in stats[ph].values())
    ckpt = assert_float32_checkpoint(out / "checkpoint.pth")
    assert not any(k.startswith("llm.") for k in ckpt["model"])


def test_legacy_rel_pos_config_encodes_as_jax(corpus):
    """``rel_pos_type: legacy`` builds the latest encoding in JAX, and in
    the port (with a warning): both models from that config, on the same
    seeded weights, give one encoder output (1e-4) on a ragged batch."""
    from test_torch_transducer import seeded_variables

    config = {**jasr.ASRTask.get_default_config(), **_tiny(corpus), "normalize": "utterance_mvn",
              "encoder_conf": {**ENC, "rel_pos_type": "legacy"}}
    jmodel, tmodel = jasr.build_model(config), tasr.build_model(config, "cpu").eval()
    rng = np.random.default_rng(9)
    speech = (rng.standard_normal((2, 6400)) * 0.3).astype(np.float32)
    lens = np.array([6400, 4100], np.int32)
    text = np.ones((2, 3), np.int32)
    variables = seeded_variables(jmodel, jnp.asarray(speech), jnp.asarray(lens),
                                 jnp.asarray(text), jnp.asarray([3, 3]), seed=9)
    tmodel.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    j_enc, j_lens = jit(lambda s, n: jmodel.apply(variables, s, n, method=jmodel.encode))(
        jnp.asarray(speech), jnp.asarray(lens))
    with torch.no_grad():
        t_enc, t_lens = tmodel.encode(torch.from_numpy(speech), torch.from_numpy(lens).long())
    assert t_lens.tolist() == np.asarray(j_lens).tolist()
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(j_enc), rtol=1e-4, atol=1e-4)


def test_port_decodes_the_jax_guided_directory(corpus, jax_guided):
    root = corpus
    tinference.main([
        "--asr_train_config", str(jax_guided / "config.yaml"),
        "--asr_model_file", str(jax_guided / "init.msgpack"),
        "--data_path_and_name_and_type", f"{root / 'valid' / 'wav.scp'},speech,sound",
        "--output_dir", str(root / "tgdec"), "--device", "cpu", "--beam_size", "4",
        "--maxlenratio", "0.5"])
    _compare_decodes(root / "tgdec", root / "jgdec")


def test_port_serves_a_jax_bf16_directory_in_float32_unless_asked(corpus, jax_guided):
    """A directory that JAX's ASRTask wrote for ``train_dtype: bfloat16``
    (its config.yaml; the float32 variables of the guided directory, which
    a bfloat16 model's init also gives): JAX serves it in float32 by
    default, and so does the port, writing JAX's files (the float32
    decode above); asked for bfloat16, the port's model computes in it and
    decodes every utterance from float32 parameters."""
    root = corpus
    out = root / "jguided_bf16"
    jasr.ASRTask.main(["--config", str(root / "guided.yaml"), "--dry_run", "true",
                       "--train_dtype", "bfloat16", "--output_dir", str(out)])
    assert jconfig.load_yaml(out / "config.yaml")["train_dtype"] == "bfloat16"
    args = [str(out / "config.yaml"), str(jax_guided / "init.msgpack")]
    tinference.inference(str(root / "tgdec_bf16dir"), [(str(root / "valid" / "wav.scp"),
                                                        "speech", "sound")], *args,
                         device="cpu", beam_size=4, maxlenratio=0.5)
    _compare_decodes(root / "tgdec_bf16dir", root / "jgdec")
    s2t = tinference.Speech2Text(*args, device="cpu", dtype=torch.bfloat16, beam_size=4,
                                 maxlenratio=0.5)
    assert s2t.model.compute.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for n, p in s2t.model.named_parameters()
               if not n.startswith("llm."))
    from llm_guided_asr_tpu_torch.data.fileio import SoundScpReader

    reader = SoundScpReader(root / "valid" / "wav.scp")
    for uid in reader.keys():
        with torch.no_grad():
            enc, _ = s2t.model.encode(torch.from_numpy(reader[uid][1][None].astype(np.float32)),
                                      torch.tensor([len(reader[uid][1])]))
        assert enc.dtype == torch.bfloat16
        (text, tokens, ids, hyp), = s2t(reader[uid][1])
        assert np.isfinite(hyp.score)


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
