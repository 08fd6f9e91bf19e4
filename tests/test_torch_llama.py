"""Port vs JAX: a tiny Llama (GQA, llama3 rope scaling), prompt forward with
mid-row padding, then cached decode steps."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llm_guided_asr_tpu.models.llm import llama as jl
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.llm import llama as tl
from test_torch_train import jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

CFG = dict(vocab_size=61, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0,
           rope_scaling_factor=32.0, rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
           rope_original_max_position=64)


def _models():
    jmod = jl.LlamaModel(jl.LlamaConfig(**CFG), dtype=jnp.float32)
    ids = jnp.zeros((2, 12), jnp.int32)
    # seeded weights at init-like scales: no eager flax init
    variables = seeded_variables(jmod, ids, jnp.ones((2, 12), bool))
    tmod = tl.LlamaModel(tl.LlamaConfig(**CFG), dtype=torch.float32, device="cpu")
    tmod.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, variables)))
    return jmod, variables, tmod.eval()


def test_rope_frequencies_match_jax():
    for scaling in (None, 8.0):
        kw = {**CFG, "rope_scaling_factor": scaling}
        np.testing.assert_array_equal(tl.rope_frequencies(tl.LlamaConfig(**kw)),
                                      jl.rope_frequencies(jl.LlamaConfig(**kw)))


def test_prompt_forward_and_cached_steps_match_jax():
    jmod, variables, tmod = _models()
    rng = np.random.default_rng(0)
    b, tp, n_steps = 2, 12, 3
    ids = rng.integers(1, CFG["vocab_size"], (b, tp)).astype(np.int32)
    valid = np.ones((b, tp), bool)
    valid[1, 4:7] = False  # mid-row pads, as the prompt packer leaves them
    valid[0, 11] = False
    apply = jit(jmod.apply)  # eager flax compiles every op at each new shape
    j_hidden, j_cache = apply(variables, jnp.asarray(ids), jnp.asarray(valid))
    with torch.no_grad():
        t_hidden, t_cache = tmod(torch.from_numpy(ids).long(), torch.from_numpy(valid))
    np.testing.assert_allclose(t_hidden.numpy()[valid], np.asarray(j_hidden)[valid],
                               rtol=1e-4, atol=1e-5)
    for (jk, jv), (tk, tv) in zip(j_cache["layers"], t_cache):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)

    # cached steps: JAX concatenates the growing cache; the port writes the
    # new k/v in place into fixed buffers of tp + n_steps positions
    nvalid = valid.sum(1)
    j_layers = list(j_cache["layers"])
    j_valid = jnp.asarray(valid)
    hkv, hd = CFG["num_key_value_heads"], CFG["hidden_size"] // CFG["num_attention_heads"]
    bufs = []
    for tk, tv in t_cache:
        kb = torch.zeros(b, tp + n_steps, hkv, hd)
        vb = torch.zeros(b, tp + n_steps, hkv, hd)
        kb[:, :tp], vb[:, :tp] = tk, tv
        bufs.append((kb, vb))
    t_valid = torch.zeros(b, tp + n_steps, dtype=torch.bool)
    t_valid[:, :tp] = torch.from_numpy(valid)
    for step in range(n_steps):
        tok = rng.integers(1, CFG["vocab_size"], (b, 1)).astype(np.int32)
        pos = (nvalid + step)[:, None]
        j_h, j_new = apply(variables, jnp.asarray(tok), jnp.ones((b, 1), bool),
                           cache={"layers": j_layers}, cache_valid=j_valid,
                           positions=jnp.asarray(pos))
        j_layers = [(jnp.concatenate([ck, nk], 1), jnp.concatenate([cv, nv], 1))
                    for (ck, cv), (nk, nv) in zip(j_layers, j_new["layers"])]
        j_valid = jnp.concatenate([j_valid, jnp.ones((b, 1), bool)], 1)
        with torch.no_grad():
            t_h, _ = tmod(torch.from_numpy(tok).long(), torch.ones(b, 1, dtype=torch.bool),
                          cache=bufs, cache_valid=t_valid, positions=torch.from_numpy(pos),
                          cache_write_pos=tp + step)
        t_valid[:, tp + step] = True
        np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {step}")
