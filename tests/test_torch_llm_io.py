"""Port vs JAX: Llama logits (tied and untied heads), checkpoints streamed
tensor by tensor from one file or from shards, and the guided model built
from a task config whose LLM is a local directory."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from transformers import AutoConfig

from llm_guided_asr_tpu.models.llm.ingest import stream_llm_params
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.llm.llama import LlamaModel as JLlamaModel
from llm_guided_asr_tpu.models.llm_guided import build_llm_guided_model as j_build
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.llm.llama import (
    LlamaConfig,
    LlamaModel,
    load_llama_dir,
    load_safetensors,
    stream_checkpoint,
)
from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
from llm_guided_asr_tpu_torch.models.llm_guided import build_llm_guided_model, load_llm_params
from test_torch_train import jit

torch.set_num_threads(1)

BPE_DIR = Path(__file__).resolve().parent / "parity" / "tiny_llm_bpe"
LLM = dict(vocab_size=40, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2)


@pytest.mark.parametrize("tied", [False, True])
def test_return_logits_matches_jax(tied):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 40, (2, 9)).astype(np.int32)
    valid = np.ones((2, 9), bool)
    valid[1, 6:] = False
    jmod = JLlamaModel(JLlamaConfig(**LLM, tie_word_embeddings=tied), dtype=jnp.float32)
    variables = jit(lambda k: jmod.init(k, jnp.asarray(ids), jnp.asarray(valid),
                                            return_logits=True))(jax.random.PRNGKey(0))
    _, j_logits, _ = jit(lambda v, i, m: jmod.apply(v, i, m, return_logits=True))(
        variables, jnp.asarray(ids), jnp.asarray(valid))
    tmod = LlamaModel(LlamaConfig(**LLM, tie_word_embeddings=tied), dtype=torch.float32,
                      device="cpu", lm_head=True)
    assert hasattr(tmod, "lm_head") != tied
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    with torch.no_grad():
        _, t_logits, _ = tmod(torch.from_numpy(ids).long(), torch.from_numpy(valid),
                              return_logits=True)
    np.testing.assert_allclose(t_logits.numpy()[valid], np.asarray(j_logits)[valid],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="lm_head"):
        LlamaModel(LlamaConfig(**LLM), dtype=torch.float32, device="cpu")(
            torch.from_numpy(ids).long(), torch.from_numpy(valid), return_logits=True)


def _shard(src: Path, dst: Path) -> Path:
    """src's checkpoint rewritten as two shards with an index, the other
    files copied."""
    dst.mkdir()
    for f in src.iterdir():
        if f.name != "model.safetensors":
            (dst / f.name).write_bytes(f.read_bytes())
    tensors = {k: v.numpy() for k, v in load_safetensors(src / "model.safetensors").items()}
    names = sorted(tensors)
    weight_map = {}
    for i, part in enumerate((names[::2], names[1::2])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: tensors[k] for k in part}, str(dst / fname))
        weight_map.update({k: fname for k in part})
    (dst / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    return dst


def test_sharded_checkpoint_loads_as_one_file(tmp_path):
    sharded = _shard(BPE_DIR, tmp_path / "sharded")
    cfg, one = load_llama_dir(BPE_DIR)
    _, two = load_llama_dir(sharded)
    assert one.keys() == two.keys() and "lm_head.weight" in one
    for k in one:
        assert torch.equal(one[k], two[k]), k
    # the JAX streamed ingest of the shards, name for name and value for value
    j = params_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, stream_llm_params(sharded, JLlamaConfig.from_hf_config(
            AutoConfig.from_pretrained(BPE_DIR)), dtype=np.float32))})
    assert j.keys() == two.keys()
    for k in j:
        assert torch.equal(j[k], two[k]), k
    bf16 = stream_checkpoint(sharded, cfg, dtype=torch.bfloat16)
    for k in one:
        assert bf16[k].dtype == torch.bfloat16 and torch.equal(bf16[k], one[k].bfloat16()), k


def _config(llm_dir, **model_conf):
    return {
        "llm_conf": {"model_name_or_path": str(llm_dir), "template_prompt": 'fix "((HYP))" then reply: ',
                     "dtype": "float32", "pad_token": "<unk>"},
        "frontend_conf": {"n_fft": 256, "hop_length": 128, "n_mels": 23},
        "normalize": "utterance_mvn",
        "encoder_conf": {"output_size": 32, "attention_heads": 2, "linear_units": 64,
                         "num_blocks": 2, "macaron_style": True, "cnn_module_kernel": 7},
        "decoder_conf": {"attention_heads": 2, "linear_units": 64, "num_blocks": 2},
        "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1, **model_conf},
    }


@pytest.mark.parametrize("mode", ["hidden", "log_softmax"])
def test_build_from_config_matches_jax(tmp_path, mode):
    """The config, template and LLM weights of build_llm_guided_model +
    load_llm_params, against JAX's build_llm_guided_model, from a sharded directory."""
    sharded = _shard(BPE_DIR, tmp_path / "llm")
    config = _config(sharded, llm_score_mode=mode)
    jm = j_build(config)
    tm = build_llm_guided_model(config, device="cpu")
    jc, tc = jm.cfg, tm.cfg
    assert tc.prompt == PromptTemplate(**jc.prompt.__dict__) and tc.vocab_size == jc.vocab_size == 54
    assert tc.llm.__dict__ == {k: v for k, v in jc.llm.__dict__.items() if k in tc.llm.__dict__}
    for name in ("ctc_weight", "lsm_weight", "normalize", "llm_score_mode", "ctc_vocab_size"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.encoder.num_blocks == jc.encoder.num_blocks == 2
    assert tc.frontend.n_mels == jc.frontend.n_mels == 23
    sd = load_llm_params(config, model=tm)
    _, want = load_llama_dir(BPE_DIR)
    for k, v in tm.llm.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert ("lm_head.weight" in tm.llm.state_dict()) == (mode == "log_softmax")
    assert sd.keys() == want.keys()


def test_llm_name_that_is_no_local_directory_raises(tmp_path):
    config = _config(tmp_path / "meta-llama" / "Llama-3.2-1B")
    with pytest.raises(FileNotFoundError, match="Llama-3.2-1B.*nothing is downloaded"):
        build_llm_guided_model(config, device="cpu")
    config = _config("meta-llama/Llama-3.2-1B")
    config["llm_conf"]["cache_dir"] = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="meta-llama/Llama-3.2-1B"):
        load_llm_params(config, device="cpu")
