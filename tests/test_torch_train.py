"""Port vs JAX, the phase-1 training slice: the transformer decoder, the
ASRModel loss and gradients, and three fused train steps, all from the
same weights with every dropout at 0 and SpecAug off (phase 2 is in
tests/test_torch_train_guided.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.transformer_decoder import TransformerDecoder as JDecoder
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JDecoderConfig,
)
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.transformer_decoder import (
    TransformerDecoder,
    TransformerDecoderConfig,
)
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

# the JAX references' jit: XLA's HLO passes as always (where it rounds
# bfloat16 is decided there), its LLVM backend unoptimized, which compiles
# a model's step in ~60 % of the time to the same values within float32
# rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)

VOCAB = 12
NO_DROP_ENC = dict(dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)
NO_DROP_DEC = dict(dropout_rate=0.0, positional_dropout_rate=0.0)
# tests/test_asr_model.py's tiny config, dropout off, one block each: every
# parameter kind is there, and XLA compiles the training step in half the
# time of two blocks (~11 against ~20 s a step on one CPU thread)
ASR = dict(
    frontend=dict(n_fft=128, hop_length=64, n_mels=20),
    encoder=dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1,
                 macaron_style=True, use_cnn_module=True, cnn_module_kernel=7, **NO_DROP_ENC),
    decoder=dict(attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_DEC),
)
OPT = {"lr": 1e-3, "eps": 1e-3}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(rng, b=3, s=3200, l=5, lo=1, hi=VOCAB - 1):
    speech = (rng.standard_normal((b, s)) * 0.5).astype(np.float32)
    speech_lengths = np.array([s, s - 700, s // 2], np.int32)[:b]
    text_lengths = np.array([l, l - 2, l - 1], np.int32)[:b]
    text = rng.integers(lo, hi, (b, l)).astype(np.int32)
    text = np.where(np.arange(l)[None, :] < text_lengths[:, None], text, -1).astype(np.int32)
    return {"speech": speech, "speech_lengths": speech_lengths, "text": text,
            "text_lengths": text_lengths}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


def _assert_state_close(tmodel, variables, atol, names=None):
    want = params_from_jax(_np(variables))
    got = tmodel.state_dict()
    for name in names if names is not None else want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def asr():
    jcfg = JASRModelConfig(vocab_size=VOCAB, frontend=JFrontendConfig(**ASR["frontend"]),
                           normalize="utterance_mvn", encoder=JConformerConfig(**ASR["encoder"]),
                           decoder=JDecoderConfig(**ASR["decoder"]), ctc_weight=0.3)
    tcfg = ASRModelConfig(vocab_size=VOCAB, frontend=FrontendConfig(**ASR["frontend"]),
                          normalize="utterance_mvn", encoder=ConformerConfig(**ASR["encoder"]),
                          decoder=TransformerDecoderConfig(**ASR["decoder"]), ctc_weight=0.3)
    jmodel = JASRModel(jcfg)
    batch = _batch(np.random.default_rng(0))
    from test_torch_transducer import seeded_variables  # it imports this module

    # seeded weights at init-like scales, no flax init to compile
    variables = seeded_variables(jmodel, *(jnp.asarray(batch[k])
                                           for k in jtrainer.DEFAULT_BATCH_ARGS))
    return jmodel, variables, tcfg, batch


def _port_asr(tcfg, variables):
    tmodel = ASRModel(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return tmodel


def test_transformer_decoder_logits_match_jax():
    cfg = dict(attention_heads=2, linear_units=24, num_blocks=2)
    rng = np.random.default_rng(1)
    mem = rng.standard_normal((2, 9, 16)).astype(np.float32)
    mem_lens = np.array([9, 6], np.int32)
    ys = rng.integers(0, VOCAB, (2, 6)).astype(np.int32)
    ys_lens = np.array([6, 4], np.int32)
    jdec = JDecoder(VOCAB, JDecoderConfig(**cfg))
    args = [jnp.asarray(x) for x in (mem, mem_lens, ys, ys_lens)]
    from test_torch_transducer import seeded_variables  # it imports this module

    variables = seeded_variables(jdec, *args, seed=1)
    tdec = TransformerDecoder(VOCAB, TransformerDecoderConfig(**cfg), 16)
    tdec.load_state_dict(params_from_jax(_np(variables)), strict=True)
    tdec.eval()
    with torch.no_grad():
        got = tdec(*(torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)
                     for x in (mem, mem_lens, ys, ys_lens)))
    want = np.asarray(jit(jdec.apply)(variables, *args))
    for b, n in enumerate(ys_lens):
        np.testing.assert_allclose(got.numpy()[b, :n], want[b, :n], rtol=1e-5, atol=1e-5)


def test_asr_model_loss_stats_and_gradients_match_jax(asr):
    jmodel, variables, tcfg, batch = asr
    jargs = [jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS]

    def j_loss(params):
        (loss, stats, weight), _ = jmodel.apply({**variables, "params": params}, *jargs,
                                                deterministic=False, mutable=["batch_stats"])
        return loss, (stats, weight)

    (_, (j_stats, j_weight)), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    tmodel = _port_asr(tcfg, variables).train()
    loss, stats, weight = tmodel(*_torch_batch(batch).values())
    loss.backward()
    assert float(weight) == float(j_weight) == 3.0
    assert stats.keys() == j_stats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_three_fused_train_steps_match_jax(asr):
    """Phase 1: adam (eps 1e-3, so that a near-zero gradient's rounding
    noise cannot flip a first update by 2 lr), clip 5, three steps on three
    batches; batch-norm statistics move in both."""
    jmodel, variables, tcfg, _ = asr
    batches = [_batch(np.random.default_rng(10 + i)) for i in range(3)]
    tx = joptim.build_optimizer("adam", dict(OPT))
    state = jtrainer.init_train_state(variables, tx)
    j_step = jtrainer.make_fused_train_step(jmodel, tx)
    params, opt, extra = state["params"], state["opt_state"], state["extra"]
    j_losses = []
    for batch in batches:
        params, opt, extra, stats, _ = j_step(params, opt, extra,
                                              {k: jnp.asarray(v) for k, v in batch.items()},
                                              jax.random.PRNGKey(0))
        j_losses.append(float(stats["loss"]))

    tmodel = _port_asr(tcfg, variables)
    tstate = ttrainer.init_train_state(tmodel, toptim.build_optimizer("adam", dict(OPT)))
    t_step = ttrainer.make_fused_train_step(tmodel, tstate, torch.Generator().manual_seed(0))
    t_losses = [float(t_step(_torch_batch(b))[0]["loss"]) for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert tstate.step == 3
    _assert_state_close(tmodel, {"params": params, **extra}, atol=1e-5)


def test_init_weights_covers_the_asr_model(asr):
    from llm_guided_asr_tpu_torch.convert import init_weights

    tcfg = asr[2]
    model = init_weights(ASRModel(tcfg, device="cpu"), seed=3)
    emb = model.decoder.embed.weight.detach()
    assert emb.shape == (VOCAB, 16) and 0.01 < float(emb.std()) < 0.03
    bn = model.encoder.block_0.conv_module.norm
    assert torch.all(bn.weight == 1) and torch.all(bn.running_var == 1)
    assert torch.all(bn.running_mean == 0) and torch.all(model.ctc_head.bias == 0)
    again = init_weights(ASRModel(tcfg, device="cpu"), seed=3)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_training_with_dropout_needs_a_step_rng(asr):
    from llm_guided_asr_tpu_torch.utils.rng import StepRNG

    cfg = ASRModelConfig(vocab_size=VOCAB, frontend=FrontendConfig(**ASR["frontend"]),
                         normalize="utterance_mvn",
                         encoder=ConformerConfig(**{**ASR["encoder"], "attention_dropout_rate": 0.1}),
                         decoder=TransformerDecoderConfig(**ASR["decoder"]), ctc_weight=0.3)
    model = ASRModel(cfg, device="cpu").train()
    batch = list(_torch_batch(asr[3]).values())
    with pytest.raises(ValueError, match="StepRNG"):
        model(*batch)
    rng = lambda: StepRNG(torch.Generator().manual_seed(7))  # noqa: E731
    a, b = (model(*batch, rng=rng())[0].detach() for _ in range(2))
    assert torch.isfinite(a) and float(a) == float(b)  # the same seed, the same dropout
    with torch.no_grad():
        model.eval()
        assert torch.isfinite(model(*batch)[0])  # eval mode draws nothing


class _ScaledSum(torch.nn.Module):
    """loss = scale * sum(w): every gradient equals ``scale``."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(1000))
        self.scale = 1.0

    def forward(self, speech, speech_lengths, text, text_lengths, rng=None):
        loss = (self.w * self.scale).sum()
        return loss, {"loss": loss.detach()}, torch.tensor(1.0)


@pytest.mark.parametrize("scale, applied", [(1e30, True), (float("inf"), False),
                                            (float("nan"), False)])
def test_fused_step_skips_only_non_finite_gradients(scale, applied):
    """As the JAX step: a non-finite gradient skips the update; finite
    gradients whose global norm overflows float32 are clipped (to 0) and
    the update, carried by Adam's moments, is applied."""
    model = _ScaledSum()
    state = ttrainer.init_train_state(model, toptim.build_optimizer("adam", {"lr": 1e-3}))
    step = ttrainer.make_fused_train_step(model, state, torch.Generator().manual_seed(0))
    batch = dict.fromkeys(ttrainer.BATCH_ARGS, torch.zeros(1, 1))
    step(batch)
    before = model.w.detach().clone()
    model.scale = scale
    step(batch)
    assert state.step == (2 if applied else 1)
    assert torch.isfinite(model.w).all()
    assert torch.equal(model.w, before) != applied
