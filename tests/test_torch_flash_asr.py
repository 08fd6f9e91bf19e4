"""Port vs JAX, the flash-attention Conformer's CTC/attention model: a tiny
flash/abs_pos ASRModel (head dim 64, so the port's attention is the flash op
on every block) from flax's own init, carried across by params_from_jax.
Its loss and every parameter's gradient, one fused AdamW step, beam-4
Speech2Text with the stateless scorer, and the greedy CTC dispatch, against
the JAX package on the CPU (whose FlashSelfAttention takes its dense branch
here: the valid frames, and so everything downstream, agree)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JDecoderConfig,
)
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.search.greedy import ctc_greedy_decode as j_greedy
from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.flash_attention import KERNEL as FLASH_KERNEL
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.search.scorers import StatelessAttScorer
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, _assert_state_close, _batch, _np, \
    _torch_batch, jit

torch.set_num_threads(1)

VOCAB = 12
SOS = EOS = VOCAB - 1
FLASH_ASR = dict(
    frontend=dict(n_fft=128, hop_length=64, n_mels=20),
    encoder=dict(output_size=128, attention_heads=2, linear_units=32, num_blocks=2,
                 macaron_style=True, cnn_module_kernel=7, pos_enc_layer_type="abs_pos",
                 selfattention_layer_type="flash", **NO_DROP_ENC),
    decoder=dict(attention_heads=2, linear_units=32, num_blocks=2, **NO_DROP_DEC),
)
N_SAMPLES = 4000  # padded to 4800 by Speech2Text


@functools.lru_cache(maxsize=1)
def _models():
    """(JAX model, its flax-initialised variables, the port's model with the
    same weights), built once."""
    common = dict(vocab_size=VOCAB, normalize="utterance_mvn", ctc_weight=0.3)
    jcfg = JASRModelConfig(frontend=JFrontendConfig(**FLASH_ASR["frontend"]),
                           encoder=JConformerConfig(**FLASH_ASR["encoder"]),
                           decoder=JDecoderConfig(**FLASH_ASR["decoder"]), **common)
    tcfg = ASRModelConfig(frontend=FrontendConfig(**FLASH_ASR["frontend"]),
                          encoder=ConformerConfig(**FLASH_ASR["encoder"]),
                          decoder=TransformerDecoderConfig(**FLASH_ASR["decoder"]), **common)
    jmodel = JASRModel(jcfg)
    batch = _batch(np.random.default_rng(0))
    variables = jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                     *(jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS))
    tmodel = ASRModel(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return jmodel, variables, tmodel


def _speech():
    return (np.random.default_rng(11).standard_normal(N_SAMPLES) * 0.5).astype(np.float32)


def _j_encode(jmodel, variables, speech):
    """JAX's encoder output of the waveform as Speech2Text pads it."""
    padded = np.zeros((1, -(-N_SAMPLES // 1600) * 1600), np.float32)
    padded[0, :N_SAMPLES] = speech
    return jit(functools.partial(jmodel.apply, method=jmodel.encode))(
        variables, jnp.asarray(padded), jnp.asarray([N_SAMPLES], jnp.int32))


def test_flax_init_round_trips_into_the_flash_model():
    """flax init -> params_from_jax -> load_state_dict(strict=True): the
    flash block's self_attn tree (linear_q/k/v/out) maps unchanged."""
    _, variables, tmodel = _models()
    attn = variables["params"]["encoder"]["block_1"]["self_attn"]
    assert sorted(attn) == ["linear_k", "linear_out", "linear_q", "linear_v"]
    port = tmodel.encoder.block_1.self_attn
    for name in sorted(attn):
        np.testing.assert_array_equal(getattr(port, name).weight.detach().numpy(),
                                      np.asarray(attn[name]["kernel"]).T)
        np.testing.assert_array_equal(getattr(port, name).bias.detach().numpy(),
                                      np.asarray(attn[name]["bias"]))


@functools.lru_cache(maxsize=1)
def _jax_grads():
    """JAX's training-mode loss on batch 1, every dropout at 0: (its stats,
    the gradient of every parameter, the moved batch statistics), compiled
    once for both tests that read it."""
    jmodel, variables, _ = _models()
    jargs = [jnp.asarray(_batch(np.random.default_rng(1))[k])
             for k in jtrainer.DEFAULT_BATCH_ARGS]

    def j_loss(params):
        (loss, stats, _), moved = jmodel.apply({**variables, "params": params}, *jargs,
                                               deterministic=False, mutable=["batch_stats"])
        return loss, (stats, moved)

    (_, (stats, moved)), grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    return stats, grads, moved


def _port_copy(tmodel):
    model = ASRModel(tmodel.cfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    return model


def test_flash_asr_loss_and_gradients_match_jax():
    """Training mode (batch statistics), every dropout at 0: the stats at
    1e-4 and every parameter's gradient at 1e-4 of its largest value, plus
    1e-6 of the model's largest gradient: a gradient that is 0 in exact
    arithmetic (the depthwise conv's bias, which the batch norm after it
    cancels) is float32 rounding noise in both packages."""
    j_stats, j_grads, _ = _jax_grads()
    model = _port_copy(_models()[2]).train()
    before = dict(FLASH_KERNEL.launches)
    loss, stats, _ = model(*_torch_batch(_batch(np.random.default_rng(1))).values())
    loss.backward()
    assert FLASH_KERNEL.launches == before  # the CPU runs the plain versions
    assert stats.keys() == j_stats.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    floor = 1e-6 * max(float(r.abs().max()) for r in want.values())
    for name, g in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + floor, err_msg=name)


def test_one_fused_adamw_step_matches_jax():
    """The port's fused step (AdamW, eps 1e-3 as tests/test_torch_train.py's
    steps, clip 5) against what JAX's make_fused_train_step computes from
    the same gradient: optax's clip and AdamW update applied to the
    parameters, the batch statistics moved by the forward.  Loss at 1e-4,
    every weight and running statistic after the step at 1e-5."""
    _, variables, tmodel = _models()
    j_stats, j_grads, moved = _jax_grads()
    conf = {"lr": 1e-3, "eps": 1e-3}
    tx = joptim.build_optimizer("adamw", dict(conf))

    @jax.jit
    def update(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    params = update(variables["params"], j_grads)
    model = _port_copy(tmodel)
    tstate = ttrainer.init_train_state(model, toptim.build_optimizer("adamw", dict(conf)))
    t_stats, _ = ttrainer.make_fused_train_step(model, tstate, torch.Generator().manual_seed(0))(
        _torch_batch(_batch(np.random.default_rng(1))))
    np.testing.assert_allclose(float(t_stats["loss"]), float(j_stats["loss"]), rtol=1e-4)
    assert tstate.step == 1
    _assert_state_close(model, {**variables, "params": params, **moved}, atol=1e-5)


def test_beam4_speech2text_matches_jax_stateless_scorer():
    """Beam 4, ctc_weight 0.3, an 8-token cap: JAX's BatchBeamSearch with its
    default StatelessAttScorer and the port's Speech2Text give the same
    4-best token sequences, scores at 1e-4."""
    jmodel, variables, tmodel = _models()
    speech = _speech()
    enc, enc_lens = _j_encode(jmodel, variables, speech)
    j_hyps = JBeamSearch(jmodel, variables, vocab_size=VOCAB, sos=SOS, eos=EOS, beam_size=4,
                         ctc_weight=0.3)(enc, enc_lens, maxlenratio=-8.0, nbest=4)
    s2t = Speech2Text.from_model(tmodel, ctc_weight=0.3, beam_size=4, nbest=4, maxlenratio=-8.0)
    assert isinstance(s2t.beam.att_scorer, StatelessAttScorer)
    out = s2t(speech)
    assert len(out) == len(j_hyps) == 4 and any(ids for ids, _ in out)
    assert [h.yseq for _, h in out] == [h.yseq for h in j_hyps]
    assert [ids for ids, _ in out] == [[i for i in h.yseq if i != SOS] for h in j_hyps]
    np.testing.assert_allclose([h.score for _, h in out], [h.score for h in j_hyps], rtol=1e-4)
    for (_, h), jh in zip(out, j_hyps):
        assert h.scores.keys() == jh.scores.keys()
        for key in jh.scores:
            np.testing.assert_allclose(h.scores[key], jh.scores[key], rtol=1e-4, err_msg=key)


def test_greedy_ctc_dispatch_matches_jax():
    """beam_size 1 and ctc_weight 1.0: no beam search, the greedy CTC decode
    of the CTC head's log-softmax, as JAX's Speech2Text dispatches it."""
    jmodel, variables, tmodel = _models()
    speech = _speech()
    enc, enc_lens = _j_encode(jmodel, variables, speech)
    logp = jit(functools.partial(jmodel.apply, method=jmodel.ctc_log_softmax))(variables, enc)
    tokens, n = j_greedy(logp, enc_lens, blank_id=0)
    s2t = Speech2Text.from_model(tmodel, ctc_weight=1.0, beam_size=1)
    assert s2t.beam is None
    (ids, hyp), = s2t(speech)
    assert hyp.yseq == np.asarray(tokens)[0, : int(n[0])].tolist() and len(ids) > 0
    assert ids == [i for i in hyp.yseq if i != SOS]  # sos = eos = V-1 dropped, as in JAX
