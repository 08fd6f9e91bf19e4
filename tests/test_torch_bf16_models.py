"""Port vs JAX in bfloat16 compute for the transducer and for the other
encoders, decoders and post-encoders: float32 parameters on both sides
from the same weights, checked by tests/test_torch_bf16.py's three-part
rule (``check_bf16``):

1. JAX-bf16 against JAX-f32 gives JAX's own bfloat16 error, e_J;
2. port-bf16 against JAX-f32 within 2 e_J + 1e-3 max|ref|;
3. port-bf16 against JAX-bf16 within ``rel`` max|ref| plus e_J, ``rel``
   2e-2 for losses and 5e-2 for per-tensor gradients (max|ref| floored at
   1e-1 of the model's largest gradient), as that file states them.

A per-tensor gradient that misses the rule is settled, as that file
settles a miss behind a ReLU feed-forward, by rerunning the port's
bfloat16 step with every ReLU of the model (the feed-forwards', the
subsampling and VGG convs', the length adaptor's, RWKV's) taking the
float32 run's gate at the same call (:func:`relu_replayed_grads`); that
run must then meet parts 1 and 2.  Nothing else changes in it.

Covered, each model at one block over features (no frontend), a ragged
batch: an ``ASRModel`` per new encoder, each also carrying a new decoder
or post-encoder (E-Branchformer + rnn, Branchformer + lightconv,
MultiConvformer + dynamicconv, S4 + s4, VGG-RNN, RNN + the length
adaptor, Transformer + hugging_face, Longformer + the BERT post-encoder,
Whisper-style; CTC alone under an encoder that carries neither), its
losses and every gradient; the transducer with the stateless (and
``multi_blank_durations``), rnn, rwkv and mega prediction networks, its
losses and every gradient; and each
transducer search (default, alsd, tsd, nsc, mbg) of a bfloat16 LSTM
transducer against JAX's from the same encoder rows: the best
hypotheses equal, or a near tie in float32 (both sequences' best forced
alignment, :func:`forced_score`, scored by the float32 model, their gap
within twice bfloat16's scoring error of them), and the hypotheses both
lists hold scored alike.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llm_guided_asr_tpu.models import transducer as jtd
from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.hf_decoder import HFCausalDecoderConfig as JHFDecoderConfig
from llm_guided_asr_tpu.models.hf_encoder import BertBodyConfig as JBertBodyConfig
from llm_guided_asr_tpu.models.hf_encoder import HFPostEncoderConfig as JHFPostEncoderConfig
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.preencoder import LengthAdaptorConfig as JLengthAdaptorConfig
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JDecoderConfig,
)
from llm_guided_asr_tpu.search import transducer_beam as jbeam
from llm_guided_asr_tpu.search import transducer_extra as jextra
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import transducer as ttd
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.hf_decoder import HFCausalDecoderConfig
from llm_guided_asr_tpu_torch.models.hf_encoder import BertBodyConfig, HFPostEncoderConfig
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
from llm_guided_asr_tpu_torch.models.preencoder import LengthAdaptorConfig
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.search import transducer_beam as tbeam
from llm_guided_asr_tpu_torch.search import transducer_extra as textra
from test_torch_bf16 import OUT_REL, check_grads, check_stats
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, _np, _torch_batch, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
VOCAB, N_FEATS = 10, 12
ENC = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_ENC)
DEC = dict(attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_DEC)


def _batch(seed, frames=24):
    """Features [3, frames, N_FEATS] with lengths frames, -5, -9 and
    labels of 4, 2 and 3 tokens in 1..VOCAB-2, padded with -1."""
    rng = np.random.default_rng(seed)
    text_lengths = np.array([4, 2, 3], np.int32)
    text = rng.integers(1, VOCAB - 1, (3, 4)).astype(np.int32)
    return {"speech": rng.standard_normal((3, frames, N_FEATS)).astype(np.float32),
            "speech_lengths": np.array([frames, frames - 5, frames - 9], np.int32),
            "text": np.where(np.arange(4)[None] < text_lengths[:, None], text, -1).astype(np.int32),
            "text_lengths": text_lengths}


ARGS = ("speech", "speech_lengths", "text", "text_lengths")


def _jax_step(jmodel, variables, batch):
    """JAX's training-mode (dropout 0, batch statistics) losses and
    gradients, the port's names."""
    args = [jnp.asarray(batch[k]) for k in ARGS]

    def loss(params):
        (out, stats, _), _ = jmodel.apply({**variables, "params": params}, *args,
                                          deterministic=False, mutable=["batch_stats"])
        return out, stats

    (_, stats), grads = jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return {k: float(v) for k, v in stats.items()}, params_from_jax({"params": _np(grads)})


def relu_replayed_grads(model_bf16, model_f32, run):
    """The bfloat16 model's gradients of ``run(model)`` (a loss) with every
    ReLU taking the gate (h > 0) that the float32 model's run of ``run``
    took at the same call: ``torch.relu``/``F.relu`` and the stored
    ``activation`` of the feed-forwards record in the float32 run and
    replay in the bfloat16 one (both call them in the same order)."""
    relus = (torch.relu, F.relu)
    gates = []

    def record(h, *args, **kwargs):
        gates.append(h.detach() > 0)
        return relus[0](h)

    def replay(h, *args, **kwargs):
        return h * next(pending).to(h.dtype)

    def patched(model, fn):
        model = copy.deepcopy(model)
        for m in model.modules():
            if getattr(m, "activation", None) in relus:
                m.activation = fn
        return model

    model32, model16 = patched(model_f32, record), patched(model_bf16, replay)
    model16.zero_grad()
    try:
        torch.relu = F.relu = record
        run(model32)
        pending = iter(gates)
        torch.relu = F.relu = replay
        run(model16).backward()
    finally:
        torch.relu, F.relu = relus
    assert next(pending, None) is None, "the runs called ReLU a different number of times"
    return {n: p.grad for n, p in model16.named_parameters()}


def _check_step(jmodel, port, batch):
    """One training-mode step of the port's bfloat16 model against JAX's
    in both dtypes: the losses, the float32 parameters' float32 gradients
    and the float32 batch statistics; returns the names of the gradients
    settled on the float32 gates."""
    variables = port["variables"]
    (jb_stats, jb_grads) = _jax_step(jmodel.clone(dtype=jnp.bfloat16), variables, batch)
    (jf_stats, jf_grads) = _jax_step(jmodel, variables, batch)
    model = port[BF16].train()
    tb = _torch_batch(batch)
    loss, stats, _ = model(*tb.values())
    loss.backward()
    assert loss.dtype == F32 and model.compute.dtype == BF16
    assert {p.dtype for p in model.parameters()} == {F32}
    assert {b.dtype for n, b in model.named_buffers() if not n.endswith("compute")} <= {F32}
    check_stats(stats, jb_stats, jf_stats)
    return check_grads(list(model.named_parameters()), jb_grads, jf_grads, gated=lambda: (
        relu_replayed_grads(model, port[F32].train(), lambda m: m(*tb.values())[0])))


def _port_pair(cls, cfg, variables, **kw):
    port = {"variables": variables}
    for dt in (BF16, F32):
        port[dt] = cls(cfg, device="cpu", dtype=dt, **kw)
        port[dt].load_state_dict(params_from_jax(_np(variables)), strict=True)
    return port


# ---------------------------------------------------------------------------
# the CTC/attention model: every new encoder, decoder and post-encoder
# ---------------------------------------------------------------------------

TINY_LLM = dict(vocab_size=VOCAB, hidden_size=16, intermediate_size=24, num_hidden_layers=1,
                num_attention_heads=2, num_key_value_heads=1)
BERT = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=24,
            hidden_dropout=0.0, attention_dropout=0.0)
# id -> (encoder_type, encoder_conf, decoder_type, postencoder); decoder
# None: CTC alone (the transformer decoder in bf16 is tests/test_torch_bf16.py's)
# the conv2d input layer (held in bf16 by tests/test_torch_bf16.py) is slow to compile
LIN = dict(input_layer="linear")
ASR_CASES = {
    "e_branchformer-rnn": ("e_branchformer", dict(LIN, cnn_module_kernel=7), "rnn", None),
    "branchformer-lightconv": ("branchformer", dict(LIN, cnn_module_kernel=7), "lightconv",
                               None),
    "multiconvformer-dynamicconv": ("multiconvformer",
                                    dict(LIN, multicgmlp_kernel_sizes=(7, 23)), "dynamicconv",
                                    None),
    "s4-s4": ("s4", dict(LIN, ss_layers=("s4", "s4d", "ff"), ss_d_state=8), "s4", None),
    "vgg_rnn": ("vgg_rnn", {}, None, None),
    "rnn-length_adaptor": ("rnn", LIN, None, "length_adaptor"),
    "transformer-hugging_face": ("transformer", LIN, "hugging_face", None),
    "longformer-bert": ("longformer", LIN, None, "bert"),
    "whisper_style": ("whisper_style", {}, None, None),
}


def _postencoder(kind, jax_side):
    if kind == "length_adaptor":
        conf = dict(n_layers=1)
        return kind, (JLengthAdaptorConfig if jax_side else LengthAdaptorConfig)(**conf)
    if kind == "bert":
        body = (JBertBodyConfig if jax_side else BertBodyConfig)(**BERT)
        return "hugging_face_transformers", (JHFPostEncoderConfig if jax_side
                                             else HFPostEncoderConfig)(body=body)
    return None


def _asr_configs(case):
    enc_type, enc_over, dec_type, post = ASR_CASES[case]
    common = dict(vocab_size=VOCAB, frontend=None, normalize="none",
                  ctc_weight=0.3 if dec_type else 1.0, encoder_type=enc_type,
                  decoder_type=dec_type or "transformer")
    hf = dict(prefix_ids=(1,), postfix_ids=(2,), enc_frames_max=16)
    jcfg = JASRModelConfig(
        encoder=JConformerConfig(**ENC, **enc_over), decoder=JDecoderConfig(**DEC),
        postencoder=_postencoder(post, True),
        hf_decoder=JHFDecoderConfig(llm=JLlamaConfig(**TINY_LLM), **hf), **common)
    tcfg = ASRModelConfig(
        encoder=ConformerConfig(**ENC, **enc_over), decoder=TransformerDecoderConfig(**DEC),
        postencoder=_postencoder(post, False), input_size=N_FEATS,
        hf_decoder=HFCausalDecoderConfig(llm=LlamaConfig(**TINY_LLM), **hf), **common)
    return jcfg, tcfg


@pytest.mark.parametrize("case", list(ASR_CASES))
def test_asr_model_bf16_loss_and_gradients_match_jax(case):
    """One training-mode forward and backward of the CTC/attention model
    at one block, in bfloat16 (loss 0.3 CTC + 0.7 attention, or CTC alone
    where the decoder would be the transformer one, held in bf16 by
    tests/test_torch_bf16.py): the losses and every float32 gradient by
    the three-part rule."""
    jcfg, tcfg = _asr_configs(case)
    jmodel = JASRModel(jcfg)
    batch = _batch(1)
    variables = seeded_variables(jmodel, *(jnp.asarray(batch[k]) for k in ARGS), seed=5)
    _check_step(jmodel, _port_pair(ASRModel, tcfg, variables), batch)


# ---------------------------------------------------------------------------
# the transducer
# ---------------------------------------------------------------------------

PREDICTION = {
    "stateless": dict(decoder_type="stateless", embed_size=8, hidden_size=12),
    "rnn": dict(decoder_type="rnn", embed_size=8, hidden_size=12, num_layers=1),
    "rwkv": dict(decoder_type="rwkv", embed_size=8, hidden_size=12, num_layers=1),
    "mega": dict(decoder_type="mega", hidden_size=12, num_layers=1, mega_qk_size=8,
                 mega_num_heads=2),
}


def _transducer_configs(decoder, multi_blank=(), aux_ctc=0.3):
    common = dict(vocab_size=VOCAB, frontend=None, normalize="none", joint_size=12,
                  aux_ctc_weight=aux_ctc, multi_blank_durations=multi_blank)
    enc = dict(ENC, cnn_module_kernel=7, input_layer="linear")
    jcfg = jtd.TransducerModelConfig(encoder=JConformerConfig(**enc),
                                     decoder=jtd.TransducerDecoderConfig(**PREDICTION[decoder]),
                                     **common)
    tcfg = ttd.TransducerModelConfig(encoder=ConformerConfig(**enc),
                                     decoder=ttd.TransducerDecoderConfig(**PREDICTION[decoder]),
                                     input_size=N_FEATS, **common)
    return jcfg, tcfg


@pytest.mark.parametrize("decoder,multi_blank", [
    ("stateless", (2, 3)), ("rnn", ()), ("rwkv", ()), ("mega", ())],
    ids=["stateless-multi_blank", "rnn", "rwkv", "mega"])
def test_transducer_bf16_loss_and_gradients_match_jax(decoder, multi_blank):
    """One training-mode step of the transducer (Conformer block, rel-pos
    attention and the conv module; the multi-blank loss (big blanks of 2
    and 3 frames) with the stateless network, the RNN-T loss with the
    others, plus 0.3 CTC) in bfloat16: the losses and every float32
    gradient by the three-part rule.  The LSTM prediction network's rows are float32 in
    the bfloat16 model (flax promotes them), the RWKV's w and u too."""
    jcfg, tcfg = _transducer_configs(decoder, multi_blank)
    jmodel = jtd.TransducerModel(jcfg)
    batch = _batch(2)
    variables = seeded_variables(jmodel, *(jnp.asarray(batch[k]) for k in ARGS), seed=6)
    port = _port_pair(ttd.TransducerModel, tcfg, variables)
    labels = torch.tensor([[1, 2]])
    with torch.no_grad():
        g = port[BF16].decode_labels(labels)
    assert g.dtype == (F32 if decoder == "rnn" else BF16)
    _check_step(jmodel, port, batch)


BEAM, T_SEARCH = 4, 9
SEARCHES = {  # name: (JAX search, port search, keyword arguments, emissions a frame)
    "default": (jbeam.transducer_beam_decode, tbeam.transducer_beam_decode, {}, 1),
    "alsd": (jbeam.transducer_alsd_decode, tbeam.transducer_alsd_decode, {"u_max": 6}, None),
    "tsd": (jextra.transducer_tsd_decode, textra.transducer_tsd_decode, {"max_sym_exp": 3}, 2),
    "nsc": (jextra.transducer_nsc_decode, textra.transducer_nsc_decode,
            {"nstep": 2, "prefix_alpha": 2}, None),
}


@functools.lru_cache(maxsize=None)
def _search_models():
    """(JAX bfloat16 model, variables, the port's bfloat16 and float32
    models, encoder rows [1, T, 16], 8 frames valid): the LSTM
    transducer with two big blanks (9: 2 frames, 8: 3)."""
    jcfg, tcfg = _transducer_configs("rnn", (2, 3), aux_ctc=0.0)
    jmodel = jtd.TransducerModel(jcfg, dtype=jnp.bfloat16)
    variables = seeded_variables(jmodel, jnp.zeros((1, 16, N_FEATS)), jnp.asarray([16]),
                                 jnp.asarray([[1, 2]]), jnp.asarray([2]), seed=7)
    port = _port_pair(ttd.TransducerModel, tcfg, variables)
    enc = (np.random.default_rng(8).standard_normal((1, T_SEARCH, 16)) * 2.0).astype(np.float32)
    return jmodel, variables, port[BF16].eval(), port[F32].eval(), enc


@torch.no_grad()
def forced_score(model, enc, enc_len, yseq, per_frame=None, blank=0):
    """The best alignment's log-probability of the label sequence ``yseq``
    over the first ``enc_len`` frames of ``enc`` [1, T, D]: at most
    ``per_frame`` labels a frame (None: any), each frame ended by a blank,
    the joint's log-probs in float32 as the searches take them."""
    u = len(yseq)
    tokens = torch.tensor([list(yseq)]) if u else torch.zeros((1, 0), dtype=torch.long)
    g = model.decode_labels(tokens)[0]  # [U+1, H]
    logp = torch.log_softmax(model.joint_full(enc[:, :enc_len], g[None]).float(), -1)[0]
    neg = torch.tensor(-1e30, dtype=torch.float64)
    alpha = torch.full((u + 1,), -1e30, dtype=torch.float64)
    alpha[0] = 0.0
    for t in range(enc_len):
        lp = logp[t].double()  # [U+1, V]
        cur = alpha.clone()
        best = cur.clone()
        for _ in range(u if per_frame is None else per_frame):
            emit = torch.cat([neg[None], cur[:-1] + lp[torch.arange(u), tokens[0]]])
            cur = emit
            best = torch.maximum(best, cur)
        alpha = best + lp[:, blank]
    return float(alpha[u])


@pytest.mark.parametrize("search", list(SEARCHES) + ["mbg"])
def test_transducer_bf16_search_matches_jax(search):
    """Each search at beam 4 (mbg greedily) over the same float32 encoder
    rows, which both bfloat16 models cast: the best hypotheses equal, or a
    near tie in float32 (their forced scores by the float32 model part by
    no more than twice the larger bfloat16 scoring error of them, the
    scores normalized as the search normalizes them); every hypothesis
    both lists hold scored within 2e-2 of its size."""
    jmodel, variables, tmodel, t32, enc = _search_models()
    lens = np.array([T_SEARCH - 1], np.int32)
    if search == "mbg":
        ids, durs = tmodel.cfg.big_blank_ids, tmodel.cfg.multi_blank_durations
        want = jextra.transducer_multiblank_greedy(jmodel, variables, jnp.asarray(enc),
                                                   jnp.asarray(lens), ids, durs)
        with torch.inference_mode():
            got = textra.transducer_multiblank_greedy(tmodel, torch.from_numpy(enc),
                                                      torch.from_numpy(lens), ids, durs)
        assert [h.yseq for h in got] == [h.yseq for h in want]
        return
    jfn, tfn, kw, per_frame = SEARCHES[search]
    want = jfn(jmodel, variables, jnp.asarray(enc), jnp.asarray(lens), beam_size=BEAM,
               nbest=BEAM, **kw)
    with torch.inference_mode():
        got = tfn(tmodel, torch.from_numpy(enc), torch.from_numpy(lens), beam_size=BEAM,
                  nbest=BEAM, **kw)
    assert len(got) == len(want) and any(h.yseq for h in got)
    g, w = got[0], want[0]
    if g.yseq != w.yseq:
        norm = search in ("default", "alsd")  # these report score / (len + 1)
        e = torch.from_numpy(enc)

        def f32(yseq):
            s = forced_score(t32, e, int(lens[0]), yseq, per_frame)
            return s / (len(yseq) + 1) if norm else s

        def bf16(yseq):
            s = forced_score(tmodel, e, int(lens[0]), yseq, per_frame)
            return s / (len(yseq) + 1) if norm else s

        s_g, s_w = f32(g.yseq), f32(w.yseq)
        err = max(abs(bf16(g.yseq) - s_g), abs(bf16(w.yseq) - s_w), 1e-6)
        assert abs(s_g - s_w) <= 2 * err, (g, w, s_g, s_w, err)
    theirs = {tuple(h.yseq): h.score for h in want}
    for h in got:
        if tuple(h.yseq) in theirs:
            ref = theirs[tuple(h.yseq)]
            assert abs(h.score - ref) <= OUT_REL * max(1.0, abs(ref)), (h.yseq, h.score, ref)
