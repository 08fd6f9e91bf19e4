"""Port vs JAX, the rest of the transducer model: the LSTM prediction
network (one and two layers, embed width != hidden width) and the MEGA
one (simple and rotary position biases, the Toeplitz path and the FFT path
past 256 positions), their outputs and gradients; the multi-blank RNN-T
loss against the JAX loss and against a brute-force lattice; the model's
loss and every parameter's gradient with the LSTM, MEGA and multi-blank
configurations; ASRTask building each from YAML; and the weight bridges
(params_from_jax, init_weights) over both decoders.  The searches are in
tests/test_torch_transducer_extra.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import transducer as jtd
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.mega_decoder import MEGADecoder as JMEGADecoder
from llm_guided_asr_tpu.ops.rnnt import rnnt_loss as j_rnnt_loss
from llm_guided_asr_tpu.ops.rnnt import rnnt_loss_multi_blank as j_multi_blank
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu_torch.convert import init_weights, params_from_jax
from llm_guided_asr_tpu_torch.models import transducer as ttd
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.mega_decoder import MEGADecoder
from llm_guided_asr_tpu_torch.ops.rnnt import rnnt_loss, rnnt_loss_multi_blank
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from llm_guided_asr_tpu_torch.utils.config import loads_yaml
from test_torch_train import NO_DROP_ENC, _np, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

VOCAB = 9


def _grad_close(got: torch.Tensor, want: np.ndarray, what: str):
    """Gradients within 1e-4 of the largest reference gradient."""
    tol = 1e-4 * float(np.abs(want).max()) + 1e-7
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol, err_msg=what)


def _mega_variables(jdec, labels, seed):
    """seeded_variables with MEGA's leaves at working scales: the EMA's
    decay and damping logits spread, its expansion signs alternating, the
    query/key scales near 1 and position biases of 0.3."""
    variables = _np(seeded_variables(jdec, jnp.asarray(labels), seed=seed))
    rng = np.random.default_rng(seed + 100)
    params = variables["params"]
    for name, block in params.items():
        if not name.startswith("mega_"):
            continue
        ema = block["ema"]
        d, n = ema["damping_factor"].shape
        for leaf in ("damping_factor", "decay_factor"):
            ema[leaf] = rng.standard_normal((d, n)).astype(np.float32)
        ema["ema_expansion_matrix"] = (np.where(np.arange(n) % 2, -1.0, 1.0)[None, :]
                                       + 0.2 * rng.standard_normal((d, n))).astype(np.float32)
        ema["kernel_projection_matrix"] = rng.standard_normal((d, n)).astype(np.float32)
        block["qk_weight"] = (1.0 + 0.3 * rng.standard_normal((2, block["qk_weight"].shape[1]))
                              ).astype(np.float32)
        for leaf, arr in block["rel_pos_bias"].items():
            block["rel_pos_bias"][leaf] = (0.3 * rng.standard_normal(arr.shape)).astype(np.float32)
    return variables


def _decoder_parity(jdec, tdec, variables, labels):
    """The port's decoder against the flax one: outputs at 1e-5, and the
    gradients of a seeded projection of the outputs at 1e-4 * max|ref|."""
    tdec.load_state_dict(params_from_jax(variables), strict=True)
    proj = np.random.default_rng(1).standard_normal(
        (labels.shape[0], labels.shape[1] + 1, tdec.cfg.hidden_size)).astype(np.float32)

    def j_obj(params):
        out = jdec.apply({"params": params}, jnp.asarray(labels))
        return jnp.sum(out * proj), out

    (_, want), j_grads = jit(jax.value_and_grad(j_obj, has_aux=True))(variables["params"])
    tdec.zero_grad()
    got = tdec.eval()(torch.from_numpy(labels).long())
    (got * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want_grads = params_from_jax({"params": _np(j_grads)})
    got_grads = {n: p.grad for n, p in tdec.named_parameters()}
    assert got_grads.keys() == want_grads.keys()
    for name, g in got_grads.items():
        _grad_close(g, want_grads[name].numpy(), name)
    return got


@pytest.mark.parametrize("num_layers", [1, 2])
def test_lstm_decoder_matches_jax(num_layers):
    """embed 12 into hidden 20: the first cell's input Linears are [20, 12],
    named as flax names them (OptimizedLSTMCell_{i})."""
    kw = dict(decoder_type="rnn", embed_size=12, hidden_size=20, num_layers=num_layers)
    labels = np.array([[1, 7, 3, 0, 11], [4, 4, 2, 6, 5]], np.int32)  # 11: clipped
    jdec = jtd.RNNDecoder(VOCAB, jtd.TransducerDecoderConfig(**kw))
    variables = _np(seeded_variables(jdec, jnp.asarray(labels), seed=num_layers))
    assert set(variables["params"]) == {"embed"} | {f"OptimizedLSTMCell_{i}"
                                                    for i in range(num_layers)}
    tdec = ttd.RNNDecoder(VOCAB, ttd.TransducerDecoderConfig(**kw))
    assert tdec.OptimizedLSTMCell_0.ii.weight.shape == (20, 12)
    got = _decoder_parity(jdec, tdec, variables, labels)
    assert got.shape == (2, 6, 20)


@pytest.mark.parametrize("bias,length", [("simple", 7), ("rotary", 7), ("simple", 300),
                                         ("rotary", 300)],
                         ids=["simple-toeplitz", "rotary-toeplitz", "simple-fft", "rotary-fft"])
def test_mega_decoder_matches_jax(bias, length):
    """Two blocks at D=8 (qk 6, 2 EMA heads); 300 labels give 301 positions,
    past the Toeplitz product's 256: the rfft/irfft path."""
    kw = dict(decoder_type="mega", hidden_size=8, num_layers=2, mega_qk_size=6,
              mega_num_heads=2, mega_rel_pos_bias=bias, mega_max_positions=320)
    labels = np.random.default_rng(length).integers(0, VOCAB, (2, length)).astype(np.int32)
    jdec = JMEGADecoder(VOCAB, jtd.TransducerDecoderConfig(**kw))
    variables = _mega_variables(jdec, labels, seed=3)
    tdec = MEGADecoder(VOCAB, ttd.TransducerDecoderConfig(**kw))
    assert tdec.final_norm.eps == tdec.mega_1.norm.eps == 1e-6  # bare flax LayerNorms
    got = _decoder_parity(jdec, tdec, variables, labels)
    assert got.shape == (2, length + 1, 8)


def test_mega_decoder_keeps_the_position_range_check():
    tdec = MEGADecoder(VOCAB, ttd.TransducerDecoderConfig(
        decoder_type="mega", hidden_size=8, num_layers=1, mega_max_positions=4))
    tdec(torch.zeros((1, 3), dtype=torch.long))
    with pytest.raises(ValueError, match="max_positions"):
        tdec(torch.zeros((1, 4), dtype=torch.long))


_j_mb_value_and_grad = jit(jax.value_and_grad(j_multi_blank),
                               static_argnames=("blank_id", "big_blank_ids",
                                                "big_blank_durations", "sigma"))


def _loss_inputs(seed, b=2, t=6, u=3, v=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
    labels = rng.integers(1, 5, (b, u)).astype(np.int32)
    return logits, labels, np.array([t, t - 2], np.int32), np.array([u, u - 1], np.int32)


def _torch_loss(fn, logits, labels, tl, ul, *args, grad=False):
    x = torch.from_numpy(logits).requires_grad_(grad)
    loss = fn(x, torch.from_numpy(labels).long(), torch.from_numpy(tl), torch.from_numpy(ul),
              *args)
    if grad:
        loss.backward()
    return loss, x.grad


@pytest.mark.parametrize("ids,durs,sigma", [((6, 5), (2, 3), 0.1), ((6, 5, 4), (2, 4, 8), 0.05)],
                         ids=["durations-2-3", "durations-2-4-8"])
def test_multi_blank_loss_and_gradient_match_jax(ids, durs, sigma):
    """Durations 2, 4 and 8 over 9 frames: a ring of 8 diagonals, and a
    big blank longer than the shorter utterance (7 frames)."""
    logits, labels, tl, ul = _loss_inputs(len(durs), t=9)
    jloss, jgrad = _j_mb_value_and_grad(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(tl), jnp.asarray(ul), blank_id=0,
                                        big_blank_ids=ids, big_blank_durations=durs, sigma=sigma)
    loss, grad = _torch_loss(rnnt_loss_multi_blank, logits, labels, tl, ul, 0, ids, durs, sigma,
                             grad=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _grad_close(grad, np.asarray(jgrad), "d loss / d logits")


def _brute(logp, lab, T, U, blank, bigs, sigma):
    """Every path of the lattice in float64 (a copy of the brute force of
    tests/test_transducer_extra.py)."""
    def ladd(x, y):
        if x is None:
            return y
        m = max(x, y)
        return m + math.log(math.exp(x - m) + math.exp(y - m))

    A = {(0, 0): 0.0}
    for t in range(T):
        for u in range(U + 1):
            if (t, u) not in A:
                continue
            base = A[(t, u)]
            if u < U:
                A[(t, u + 1)] = ladd(A.get((t, u + 1)), base + logp[t, u, lab[u]] - sigma)
            if t + 1 < T:
                A[(t + 1, u)] = ladd(A.get((t + 1, u)), base + logp[t, u, blank] - sigma)
            for bid, dur in bigs:
                if t + dur < T:
                    A[(t + dur, u)] = ladd(A.get((t + dur, u)), base + logp[t, u, bid] - sigma)
    ll = A[(T - 1, U)] + logp[T - 1, U, blank] - sigma
    for bid, dur in bigs:
        if T - dur >= 0 and (T - dur, U) in A:
            ll = ladd(ll, A[(T - dur, U)] + logp[T - dur, U, bid] - sigma)
    return ll


def test_multi_blank_loss_against_brute_force_and_rnnt_loss():
    """The brute-force lattice with big blanks and sigma; no big blanks and
    sigma 0 is rnnt_loss; sigma alone adds sigma per transition (T + U)."""
    logits, labels, tl, ul = _loss_inputs(0, t=5)
    logp = torch.log_softmax(torch.from_numpy(logits).double(), -1).numpy()
    bigs = [(6, 2), (5, 3)]
    want = -np.mean([_brute(logp[i], labels[i], int(tl[i]), int(ul[i]), 0, bigs, 0.1)
                     for i in range(2)])
    got, _ = _torch_loss(rnnt_loss_multi_blank, logits, labels, tl, ul, 0, (6, 5), (2, 3), 0.1)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    plain, _ = _torch_loss(rnnt_loss, logits, labels, tl, ul)
    none, _ = _torch_loss(rnnt_loss_multi_blank, logits, labels, tl, ul)
    np.testing.assert_allclose(float(none), float(plain), rtol=1e-6)
    jplain = j_rnnt_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(tl),
                         jnp.asarray(ul))
    np.testing.assert_allclose(float(plain), float(jplain), rtol=1e-5)
    sig, _ = _torch_loss(rnnt_loss_multi_blank, logits, labels, tl, ul, 0, (), (), 0.3)
    np.testing.assert_allclose(float(sig), float(plain) + 0.3 * np.mean(tl + ul), rtol=1e-5)


# model configurations: (JAX config, port config, the model's inputs)
ENC = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1,
           use_cnn_module=False, **NO_DROP_ENC)


def _model_configs(kind):
    dec = {"rnn": dict(decoder_type="rnn", embed_size=12, hidden_size=16, num_layers=2),
           "mega": dict(decoder_type="mega", hidden_size=16, num_layers=2, mega_qk_size=8,
                        mega_num_heads=2),
           "multi_blank": dict(decoder_type="rnn", embed_size=16, hidden_size=16)}[kind]
    common = dict(vocab_size=VOCAB, normalize="utterance_mvn", joint_size=16,
                  aux_ctc_weight=0.1)
    if kind == "multi_blank":  # features in, no frontend; big blanks of 2 and 4 frames
        common.update(multi_blank_durations=(2, 4), multi_blank_sigma=0.05)
        jfront = tfront = None
    else:
        from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
        from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig

        fe = dict(n_fft=128, hop_length=64, n_mels=20)
        jfront, tfront = JFrontendConfig(**fe), FrontendConfig(**fe)
    jcfg = jtd.TransducerModelConfig(frontend=jfront, encoder=JConformerConfig(**ENC),
                                     decoder=jtd.TransducerDecoderConfig(**dec), **common)
    tcfg = ttd.TransducerModelConfig(frontend=tfront, encoder=ConformerConfig(**ENC),
                                     decoder=ttd.TransducerDecoderConfig(**dec),
                                     input_size=8 if tfront is None else None, **common)
    rng = np.random.default_rng(7)
    if tfront is None:
        speech = rng.standard_normal((2, 24, 8)).astype(np.float32)
        lengths = np.array([24, 19], np.int32)
    else:
        speech = rng.standard_normal((2, 1600)).astype(np.float32)
        lengths = np.array([1600, 1100], np.int32)
    batch = (speech, lengths, np.array([[1, 2, 3], [4, 5, -1]], np.int32),
             np.array([3, 2], np.int32))
    return jcfg, tcfg, batch


@pytest.mark.parametrize("kind", ["rnn", "mega", "multi_blank"])
def test_transducer_loss_and_gradients_match_jax(kind):
    jcfg, tcfg, batch = _model_configs(kind)
    jmodel = jtd.TransducerModel(jcfg)
    jargs = [jnp.asarray(x) for x in batch]
    variables = seeded_variables(jmodel, *jargs, seed=5)

    def j_loss(params):
        loss, stats, _ = jmodel.apply({**variables, "params": params}, *jargs,
                                      deterministic=False)
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    tmodel = ttd.TransducerModel(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    tmodel.train()
    speech, lengths, text, tlens = (torch.from_numpy(x) for x in batch)
    loss, stats, _ = tmodel(speech, lengths, text.long(), tlens)
    loss.backward()
    assert stats.keys() == j_stats.keys() == {"loss_rnnt", "loss_ctc", "loss"}
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=2e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=name)


YAML = """\
model: transducer
token_list: {tokens}
frontend: {frontend}
input_size: {input_size}
normalize: utterance_mvn
encoder: conformer
encoder_conf:
    output_size: 16
    attention_heads: 2
    linear_units: 24
    num_blocks: 1
    use_cnn_module: false
decoder_conf:
{decoder}
model_conf:
    joint_size: 16
{model_conf}"""


@pytest.mark.parametrize("kind", ["rnn", "mega", "multi_blank"])
def test_asr_task_builds_each_transducer_from_yaml(tmp_path, kind):
    """The port's task builds the JAX task's model from the same YAML: the
    same configuration, and the flax variables load into it strictly."""
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("\n".join(["<blank>"] + list("abcdefghi") + ["<bb2>", "<bb4>"]) + "\n")
    decoder = {"rnn": "    decoder_type: rnn\n    embed_size: 12\n    hidden_size: 16\n"
                      "    num_layers: 2",
               "mega": "    decoder_type: mega\n    hidden_size: 16\n    num_layers: 2\n"
                       "    mega_qk_size: 8\n    mega_rel_pos_bias: rotary",
               "multi_blank": "    decoder_type: rnn\n    embed_size: 16\n    hidden_size: 16"}
    model_conf = ("    transducer_multi_blank_durations: [2, 4]\n"
                  "    transducer_multi_blank_sigma: 0.1\n" if kind == "multi_blank" else "")
    config = loads_yaml(YAML.format(
        tokens=tokens, frontend="none" if kind == "multi_blank" else "default",
        input_size=8 if kind == "multi_blank" else "null", decoder=decoder[kind],
        model_conf=model_conf))
    tmodel = tasr.build_model(config, device="cpu")
    jmodel = jasr.build_model(config)
    tcfg, jcfg = tmodel.cfg, jmodel.cfg
    for field in ("vocab_size", "normalize", "joint_size", "multi_blank_durations",
                  "multi_blank_ids", "multi_blank_sigma"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (tcfg.frontend is None) == (jcfg.frontend is None)
    for field in ttd.TransducerDecoderConfig.__dataclass_fields__:
        assert getattr(tcfg.decoder, field) == getattr(jcfg.decoder, field), field
    if kind == "multi_blank":
        assert tcfg.big_blank_ids == (11, 10) and tcfg.input_size == 8
        feats = jnp.zeros((1, 16, 8))
    else:
        feats = jnp.zeros((1, 1600))
    variables = seeded_variables(jmodel, feats, jnp.asarray([feats.shape[1]]),
                                 jnp.asarray([[1, 2]]), jnp.asarray([2]))
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)


def test_params_from_jax_covers_every_leaf_and_init_weights_both_decoders():
    """Every flax leaf of the LSTM and MEGA models has a home in the port
    (strict loads above); init_weights fills both from the benchmark's rule:
    the gates and MEGA's named leaves N(0, 0.02), biases 0, norms 1, the
    same seed the same weights."""
    for kind in ("rnn", "mega"):
        tcfg = _model_configs(kind)[1]
        model = init_weights(ttd.TransducerModel(tcfg, device="cpu"), seed=4)
        dec = model.decoder
        if kind == "rnn":
            cell = dec.OptimizedLSTMCell_1
            weights = [cell.ii.weight, cell.ho.weight, dec.OptimizedLSTMCell_0.ig.weight]
            assert torch.all(cell.hf.bias == 0)
        else:
            block = dec.mega_1
            weights = [block.ema.damping_factor, block.ema.kernel_projection_matrix,
                       block.qk_weight, block.rel_pos_bias.relative_position_bias,
                       dec.ffn_0.linear1.weight]
            assert torch.all(block.norm.weight == 1) and torch.all(dec.final_norm.bias == 0)
            assert torch.all(block.proj_mx.bias == 0)
        for p in weights:
            assert 0.01 < float(p.detach().std()) < 0.03
        again = init_weights(ttd.TransducerModel(tcfg, device="cpu"), seed=4)
        assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                     again.state_dict().values()))
