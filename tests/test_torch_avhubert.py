"""Port vs JAX, AV-HuBERT (models/avhubert.py) at a tiny width: the
audio-visual ``AVHubertModel`` under concat and add fusion on a ragged
batch of 22 x 20 frames (the stride-2 stem, pool and block all meet an
odd SAME pad), output at 1e-5 of its largest value and every parameter's
gradient at 1e-4 of its largest plus 1e-6 of the model's largest; the
audio-only ``AVHubertEncoder`` from ``make_encoder("avhubert")`` alike;
modality dropout's zeroed half (rate 1, so JAX's draw cannot differ);
flax's SAME padding; and an audio-only ``ASRModel`` from a task config,
loss and gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import avhubert as jav
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.conformer import make_encoder as j_make_encoder
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import avhubert as tav
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from llm_guided_asr_tpu_torch.utils.rng import StepRNG
from test_torch_branchformer import _np
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

TINY = dict(encoder_embed_dim=32, encoder_layers=2, encoder_attention_heads=2,
            encoder_ffn_embed_dim=48, dropout=0.0, resnet_channels=(8, 16),
            resnet_blocks_per_stage=1, frontend_channels=8, conv_pos=8, conv_pos_groups=4)
N_AUDIO = 12


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 6, N_AUDIO)).astype(np.float32), np.array([6, 4], np.int32),
            rng.standard_normal((2, 6, 22, 20)).astype(np.float32))


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _grads_close(got, want):
    assert got.keys() == want.keys()
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for name, g in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g, ref, rtol=0, atol=1e-4 * np.abs(ref).max() + floor,
                                   err_msg=name)


@functools.lru_cache(maxsize=None)
def _av(fuse, **extra):
    """JAX's module, its variables, output and parameter gradients (of the
    output against a fixed cotangent) on the port's names."""
    jm = jav.AVHubertModel(jav.AVHubertConfig(modality_fuse=fuse, **TINY, **extra))
    audio, lens, video = _inputs()
    variables = seeded_variables(jm, *map(jnp.asarray, (audio, lens, video)), seed=2)
    cot = np.random.default_rng(9).standard_normal((2, 6, TINY["encoder_embed_dim"]))

    def f(params):
        out, _ = jm.apply({"params": params}, audio, lens, video)
        return jnp.sum(out * cot), out

    (_, out), grads = jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    return variables, np.asarray(out), params_from_jax({"params": _np(grads)}), cot


@pytest.mark.parametrize("fuse", ["concat", "add"])
def test_audio_visual_model_matches_jax(fuse):
    variables, want, want_grads, cot = _av(fuse)
    model = tav.AVHubertModel(tav.AVHubertConfig(modality_fuse=fuse, **TINY), N_AUDIO)
    model.load_state_dict(params_from_jax(_np(variables)), strict=True)
    audio, lens, video = map(torch.from_numpy, _inputs())
    out, out_lens = model(audio, lens, video)
    _close(out.detach().numpy(), want, 1e-5)
    assert out_lens.tolist() == [6, 4]
    (out * torch.from_numpy(cot).float()).sum().backward()
    _grads_close({n: p.grad.numpy() for n, p in model.named_parameters()}, want_grads)


def test_audio_only_encoder_matches_jax():
    ccfg = dict(output_size=32, attention_heads=2, linear_units=48, num_blocks=2, dropout_rate=0.0)
    jenc = j_make_encoder("avhubert", JConformerConfig(**ccfg))
    audio, lens, _ = _inputs(1)
    variables = seeded_variables(jenc, jnp.asarray(audio), jnp.asarray(lens), seed=3)
    cot = np.random.default_rng(4).standard_normal((2, 6, 32))

    def f(params):
        out, _ = jenc.apply({"params": params}, audio, lens)
        return jnp.sum(out * cot), out

    (_, want), grads = jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    enc = make_encoder("avhubert", ConformerConfig(**ccfg), N_AUDIO, device="cpu")
    assert isinstance(enc, tav.AVHubertEncoder) and enc.cfg.audio_only
    assert not hasattr(enc.trunk, "video_resnet")
    enc.load_state_dict(params_from_jax(_np(variables)), strict=True)
    out, out_lens = enc(torch.from_numpy(audio), torch.from_numpy(lens))
    _close(out.detach().numpy(), want, 1e-5)
    assert out_lens.tolist() == lens.tolist()
    (out * torch.from_numpy(cot).float()).sum().backward()
    _grads_close({n: p.grad.numpy() for n, p in enc.named_parameters()},
                 params_from_jax({"params": _np(grads)}))


@pytest.mark.parametrize("audio_dropout", [1.0, 0.0])
def test_modality_dropout_zeroes_one_half_as_jax(audio_dropout):
    """Rate 1: the audio half (audio_dropout 1) or the video half (0) of
    the concatenated features is zeroed for the whole batch; the trunk's
    output equals JAX's in training mode."""
    extra = dict(modality_dropout=1.0, audio_dropout=audio_dropout)
    variables = _av("concat")[0]
    jm = jav.AVHubertModel(jav.AVHubertConfig(modality_fuse="concat", **TINY, **extra))
    audio, lens, video = _inputs()
    want, _ = jit(lambda v, r: jm.apply(v, audio, lens, video, deterministic=False,
                                             rngs={"dropout": r}))(variables,
                                                                   jax.random.PRNGKey(0))
    model = tav.AVHubertModel(tav.AVHubertConfig(modality_fuse="concat", **TINY, **extra),
                              N_AUDIO).train()
    model.load_state_dict(params_from_jax(_np(variables)), strict=True)
    rng = StepRNG(torch.Generator().manual_seed(0))
    a, v = model.audio_proj(torch.from_numpy(audio)), torch.ones(2, 6, 32)
    fused = model.fuse(a, v, rng)
    d = TINY["encoder_embed_dim"]
    dropped, kept = (fused[..., :d], fused[..., d:]) if audio_dropout else (fused[..., d:],
                                                                           fused[..., :d])
    assert not dropped.any() and kept.abs().min() > 0
    out, _ = model(*map(torch.from_numpy, (audio, lens, video)), rng=rng)
    _close(out.detach().numpy(), want, 1e-5)


def test_same_padding_is_flax_s():
    sizes, kernel, strides = (88, 44, 22, 11, 5), (7, 3, 3, 1, 128), (2, 2, 2, 2, 1)
    want = jax.lax.padtype_to_pads(sizes, kernel, strides, "SAME")
    got = tav.same_pad(sizes, kernel, strides)
    assert [got[2 * i: 2 * i + 2] for i in range(len(sizes))][::-1] == [tuple(p) for p in want]


def _task_config():
    return {**jasr.ASRTask.get_default_config(), "token_list": ["<blank>", "<unk>", "a", "b",
                                                                "c", "<sos/eos>"],
            "encoder": "avhubert", "normalize": "utterance_mvn",
            "frontend_conf": {"n_fft": 64, "hop_length": 32, "n_mels": N_AUDIO},
            "encoder_conf": dict(output_size=32, attention_heads=2, linear_units=48,
                                 num_blocks=1, **NO_DROP_ENC),
            "decoder_conf": dict(attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_DEC),
            "model_conf": {"ctc_weight": 0.3}}


def test_audio_only_asr_model_from_a_task_config_matches_jax():
    config = _task_config()
    rng = np.random.default_rng(5)
    batch = ((rng.standard_normal((2, 640)) * 0.5).astype(np.float32),
             np.array([640, 500], np.int32), np.array([[2, 3, 4], [4, 2, -1]], np.int32),
             np.array([3, 2], np.int32))
    jmodel = jasr.build_model(config)
    variables = seeded_variables(jmodel, *map(jnp.asarray, batch), seed=6)

    def f(params):
        (loss, stats, _), _ = jmodel.apply({**variables, "params": params}, *batch,
                                           deterministic=False, mutable=["batch_stats"],
                                           rngs={"dropout": jax.random.PRNGKey(0)})
        return loss, stats

    (_, j_stats), grads = jit(jax.value_and_grad(f, has_aux=True))(variables["params"])
    model = tasr.build_model(config, "cpu").train()
    model.load_state_dict(params_from_jax(_np(variables)), strict=True)
    loss, stats, _ = model(*(torch.from_numpy(a) if a.dtype == np.float32
                             else torch.from_numpy(a).long() for a in batch))
    loss.backward()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=2e-4,
                                   err_msg=k)
    _grads_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                 params_from_jax({"params": _np(grads)}))
