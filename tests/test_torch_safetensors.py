"""The port's Hugging Face checkpoint reader (models/llm/llama.py):
``load_safetensors`` (standard library and numpy, no ``safetensors``
package), ``LlamaConfig.from_hf_config`` on a parsed ``config.json``,
``convert_hf_state_dict`` and ``load_llama_dir``, held against the
``safetensors`` package and the JAX package's conversion."""

import dataclasses
import json
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch

from llm_guided_asr_tpu.models.llm import llama as jllama
from llm_guided_asr_tpu_torch.bin.golden_check import LLM_DIR
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.llm import llama as tllama

torch.set_num_threads(1)


def test_reader_is_bitwise_the_safetensors_package():
    path = LLM_DIR / "model.safetensors"
    got, want = tllama.load_safetensors(path), safetensors.numpy.load_file(str(path))
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        t = got[name]
        assert t.dtype == torch.float32 and tuple(t.shape) == arr.shape, name
        assert np.array_equal(t.numpy().view(np.uint32), arr.view(np.uint32)), name


def _write(path, tensors, metadata=None):
    """A safetensors file written by hand: {name: (dtype, shape, raw bytes)}."""
    header, blobs, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = metadata
    for name, (dtype, shape, raw) in tensors.items():
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)  # the format pads the header with spaces
    path.write_bytes(struct.pack("<Q", len(text)) + text + b"".join(blobs))


def test_f16_bf16_and_f32_files_written_by_hand(tmp_path):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    f16 = rng.standard_normal((2, 2, 3)).astype(np.float16)
    bf16 = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32)).to(torch.bfloat16)
    bf16_raw = bf16.view(torch.int16).numpy().astype("<i2").tobytes()
    path = tmp_path / "mixed.safetensors"
    _write(path, {
        "a.f32": ("F32", f32.shape, f32.astype("<f4").tobytes()),
        "b.f16": ("F16", f16.shape, f16.astype("<f2").tobytes()),
        "c.bf16": ("BF16", tuple(bf16.shape), bf16_raw),
        "d.scalar": ("F32", (), np.float32(2.5).tobytes()),
        "e.empty": ("F16", (0, 4), b""),
    }, metadata={"format": "pt"})
    got = tllama.load_safetensors(path)
    assert sorted(got) == ["a.f32", "b.f16", "c.bf16", "d.scalar", "e.empty"]
    assert got["a.f32"].dtype == torch.float32 and np.array_equal(got["a.f32"].numpy(), f32)
    assert got["b.f16"].dtype == torch.float16 and np.array_equal(got["b.f16"].numpy(), f16)
    assert got["c.bf16"].dtype == torch.bfloat16 and torch.equal(got["c.bf16"], bf16)
    # BF16 widens to float32 exactly: its bits are the float32's top half
    widened = (bf16.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32) << 16)
    assert np.array_equal(got["c.bf16"].float().numpy(), widened.view(np.float32))
    assert got["d.scalar"].shape == () and float(got["d.scalar"]) == 2.5
    assert got["e.empty"].shape == (0, 4)
    # the package reads the same file the same way (it has no bf16 in numpy)
    want = safetensors.numpy.load_file(str(tmp_path / "mixed.safetensors"))
    assert np.array_equal(want["b.f16"], f16) and np.array_equal(want["a.f32"], f32)


def _hf_namespace(cfg: dict):
    """The attribute view of a config that the JAX package's from_hf_config reads."""
    return types.SimpleNamespace(**cfg)


@pytest.mark.parametrize("extra", [
    {},
    {"model_type": "qwen2", "attention_bias": True, "tie_word_embeddings": True},
    {"rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}},
])
def test_config_from_a_parsed_config_json_matches_jax(extra):
    hf = {**json.loads((LLM_DIR / "config.json").read_text()), **extra}
    got = dataclasses.asdict(tllama.LlamaConfig.from_hf_config(hf))
    want = dataclasses.asdict(jllama.LlamaConfig.from_hf_config(_hf_namespace(hf)))
    assert got == want


def _synthetic_checkpoint(cfg, rng, bias: bool, lm_head: bool):
    h, hd = cfg.hidden_size, cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h), "model.norm.weight": (h,)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        shapes.update({
            f"{p}.input_layernorm.weight": (h,), f"{p}.post_attention_layernorm.weight": (h,),
            f"{p}.self_attn.q_proj.weight": (cfg.num_attention_heads * hd, h),
            f"{p}.self_attn.k_proj.weight": (cfg.num_key_value_heads * hd, h),
            f"{p}.self_attn.v_proj.weight": (cfg.num_key_value_heads * hd, h),
            f"{p}.self_attn.o_proj.weight": (h, cfg.num_attention_heads * hd),
            f"{p}.mlp.gate_proj.weight": (cfg.intermediate_size, h),
            f"{p}.mlp.up_proj.weight": (cfg.intermediate_size, h),
            f"{p}.mlp.down_proj.weight": (h, cfg.intermediate_size),
        })
        if bias:
            for proj in ("q_proj", "k_proj", "v_proj"):
                shapes[f"{p}.self_attn.{proj}.bias"] = (shapes[f"{p}.self_attn.{proj}.weight"][0],)
    if lm_head:
        shapes["lm_head.weight"] = (cfg.vocab_size, h)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
            for k, s in shapes.items()}


@pytest.mark.parametrize("bias,tied", [(False, False), (True, True), (True, False)])
def test_conversion_matches_the_jax_conversion(bias, tied):
    """The attention_bias and tie_word_embeddings branches: the port's state
    dict is the JAX tree through params_from_jax, key for key."""
    cfg = tllama.LlamaConfig(vocab_size=20, hidden_size=16, intermediate_size=24,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             attention_bias=bias, tie_word_embeddings=tied)
    jcfg = jllama.LlamaConfig(**dataclasses.asdict(cfg))
    sd = _synthetic_checkpoint(cfg, np.random.default_rng(1), bias, lm_head=True)
    got = tllama.convert_hf_state_dict(sd, cfg)
    want = params_from_jax({"params": jllama.convert_hf_state_dict(sd, jcfg)})
    assert sorted(got) == sorted(want)
    assert ("lm_head.weight" in got) == (not tied)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_llama_from_the_directory_matches_jax_logits():
    """load_llama_dir -> the port's LlamaModel gives the logits of the JAX
    model whose weights the JAX conversion made from the same file, at
    float32 tolerance, on a batch with a pad in the middle of a row."""
    cfg, sd = tllama.load_llama_dir(LLM_DIR)
    model = tllama.LlamaModel(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict({k: v for k, v in sd.items() if k != "lm_head.weight"})
    jcfg = jllama.LlamaConfig(**dataclasses.asdict(cfg))
    jtree = jllama.convert_hf_state_dict(tllama.load_safetensors(LLM_DIR / "model.safetensors"),
                                         jcfg)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg.vocab_size, (2, 9))
    valid = np.ones((2, 9), bool)
    valid[1, 4] = False
    jmodel = jllama.LlamaModel(jcfg, dtype=jnp.float32)
    _, jlogits, _ = jax.jit(lambda p, i, m: jmodel.apply({"params": p}, i, m, return_logits=True))(
        jtree, jnp.asarray(ids), jnp.asarray(valid))
    with torch.no_grad():
        hidden, _ = model(torch.from_numpy(ids), torch.from_numpy(valid))
    logits = hidden @ sd["lm_head.weight"].T
    keep = valid[..., None].repeat(cfg.vocab_size, -1)
    np.testing.assert_allclose(logits.numpy()[keep], np.asarray(jlogits)[keep], rtol=1e-5,
                               atol=1e-5)
