"""Port vs JAX: transformer blocks and the Conformer encoder, same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import conformer as jconf
from llm_guided_asr_tpu.models import transformer as jtr
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import conformer as tconf
from llm_guided_asr_tpu_torch.models import transformer as ttr


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    return module.eval()


def _randomize_batch_stats(variables, rng):
    """Non-trivial BN running statistics, so the eval BN path is exercised."""
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 1.5, x.shape) if path[-1].key == "var"
                         else rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"],
    )
    return {**variables, "batch_stats": stats}


@pytest.mark.parametrize("pad_safe_conv", [True, False])
def test_conformer_encoder_matches_jax(pad_safe_conv):
    cfg_kw = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
                  macaron_style=True, cnn_module_kernel=7, pad_safe_conv=pad_safe_conv)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 57, 20)).astype(np.float32)
    lengths = np.array([57, 40, 23], np.int32)
    jmod = jconf.ConformerEncoder(jconf.ConformerConfig(**cfg_kw))
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lengths))
    variables = _randomize_batch_stats(variables, rng)
    j_out, j_lens = jmod.apply(variables, jnp.asarray(feats), jnp.asarray(lengths))

    tmod = _load(tconf.ConformerEncoder(tconf.ConformerConfig(**cfg_kw), 20, device="cpu"),
                 variables)
    with torch.no_grad():
        t_out, t_lens = tmod(torch.from_numpy(feats), torch.from_numpy(lengths).long())
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-4)


def test_rel_pos_attention_module_matches_jax():
    b, t, d, h = 2, 19, 32, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    valid = np.arange(t)[None] < np.array([[t], [11]])
    pos = jtr.rel_pos_enc(t, d)[None]
    jmod = jtr.RelPositionMultiHeadedAttention(h, impl="dense")
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(valid)[:, None, :])
    j_out = jmod.apply(variables, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(valid)[:, None, :])
    tmod = _load(ttr.RelPositionMultiHeadedAttention(d, h), variables)
    with torch.no_grad():
        t_out = tmod(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(valid))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-5)


def test_conv2d_subsampling_and_lengths_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 31, 23)).astype(np.float32)
    jmod = jtr.Conv2dSubsampling(16)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tmod = _load(ttr.Conv2dSubsampling(23, 16), variables)
    with torch.no_grad():
        t_out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    lens = np.array([31, 30, 9, 4, 1], np.int32)
    np.testing.assert_array_equal(
        ttr.sub4_lengths(torch.from_numpy(lens), 31).numpy(),
        np.asarray(jtr.sub4_lengths(jnp.asarray(lens), 31)),
    )


def test_decoder_layer_cached_paths_match_jax():
    """Full causal forward, and the incremental one-position step with the
    input-stream buffer and precomputed memory K/V."""
    b, lq, t, d, h = 2, 5, 13, 32, 4
    rng = np.random.default_rng(3)
    tgt = rng.standard_normal((b, lq, d)).astype(np.float32)
    mem = rng.standard_normal((b, t, d)).astype(np.float32)
    tgt_mask = np.tril(np.ones((lq, lq), bool))[None].repeat(b, 0)
    mem_mask = (np.arange(t)[None] < np.array([[t], [8]]))[:, None, :]
    jmod = jtr.DecoderLayer(h, 48)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(tgt), jnp.asarray(tgt_mask),
                          jnp.asarray(mem), jnp.asarray(mem_mask))
    tmod = _load(ttr.DecoderLayer(d, h, 48), variables)
    j_full = jmod.apply(variables, jnp.asarray(tgt), jnp.asarray(tgt_mask), jnp.asarray(mem),
                        jnp.asarray(mem_mask))
    j_mk, j_mv = jmod.apply(variables, None, None, jnp.asarray(mem), None, project_mem_kv_only=True)
    step = 3
    step_mask = np.broadcast_to(np.arange(lq) <= step, (b, 1, lq))
    j_step = jmod.apply(variables, jnp.asarray(tgt[:, step:step + 1]), jnp.asarray(step_mask),
                        jnp.asarray(mem), jnp.asarray(mem_mask), self_kv=jnp.asarray(tgt),
                        mem_kv=(j_mk, j_mv))
    with torch.no_grad():
        T = torch.from_numpy
        t_full = tmod(T(tgt), T(tgt_mask), T(mem), T(mem_mask))
        t_mk, t_mv = tmod.project_mem_kv(T(mem))
        t_step = tmod(T(tgt[:, step:step + 1]), T(step_mask.copy()), T(mem), T(mem_mask),
                      self_kv=T(tgt), mem_kv=(t_mk, t_mv))
    np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_mk.numpy(), np.asarray(j_mk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step), rtol=1e-5, atol=1e-5)
    # the incremental step equals row `step` of the full causal forward
    np.testing.assert_allclose(t_step[:, 0].numpy(), t_full[:, step].numpy(), rtol=1e-5, atol=1e-5)


def test_encoder_requires_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconf.ConformerEncoder(tconf.ConformerConfig(output_size=8, attention_heads=2,
                                                     linear_units=8, num_blocks=1), 20)
