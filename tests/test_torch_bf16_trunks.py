"""Port vs JAX in bfloat16 compute for the SSL, pretrained and AV-HuBERT
trunks, the raw-audio and multichannel frontends, the contextual-block
(streaming) Conformer, the ST model and the LMs: float32 parameters on
both sides from the same weights, checked by tests/test_torch_bf16.py's
three-part rule (``check_bf16``):

1. JAX-bf16 against JAX-f32 gives JAX's own bfloat16 error, e_J;
2. port-bf16 against JAX-f32 within 2 e_J + 1e-3 max|ref|;
3. port-bf16 against JAX-bf16 within ``rel`` max|ref| plus e_J, ``rel``
   2e-2 for outputs, losses and log-probs and 5e-2 for per-tensor
   gradients (max|ref| floored at 1e-1 of the model's largest gradient).

A per-tensor gradient that misses the rule is settled as
tests/test_torch_bf16_models.py settles it: the port's bfloat16 step again
with every ReLU taking the float32 run's gate (``relu_replayed_grads``),
which must then meet parts 1 and 2.

Covered, each at one block and narrow widths on a ragged batch:

- an ``ASRModel`` per choice, built by both packages' ``build_model`` from
  a task config (``use_amp`` on the port's side), one training-mode step:
  the frozen SSL frontend (HuBERT), the ``hubert_hf``, ``wav2vec2_hf``
  (layer-norm feature extractor, pre-norm layers) and ``whisper_hf``
  encoders (their widths from tiny local ``config.json`` files, the
  weights seeded), AV-HuBERT audio-only, the sinc pre-encoder over the
  sliding window, the fused frontend, the multichannel WPE/MVDR frontend
  and the contextual-block Conformer: the losses and every gradient (none
  for the frozen trunk);
- AV-HuBERT's audio-visual forward;
- the contextual-block encoder's ``encode_chunk`` chunk by chunk with
  float32 carried contexts (as the streaming recognizer carries them),
  equal to the port's own offline pass, and ``Speech2TextStreaming``'s
  partial and final hypotheses against JAX's;
- the ST model's loss and gradients;
- the Transformer, LSTM and GRU LMs: ``nll``, the scoring log-probs and
  the gradients.
"""

import contextlib
import functools
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_inference as jai
from llm_guided_asr_tpu.bin import asr_inference_streaming as jstream
from llm_guided_asr_tpu.models import avhubert as javh
from llm_guided_asr_tpu.models import lm as jlm
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.llm.ingest import stream_llm_params
from llm_guided_asr_tpu.models.streaming import ContextualBlockConformerEncoder as JBlockEncoder
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu_torch.bin.asr_inference_streaming import Speech2TextStreaming
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import avhubert as tavh
from llm_guided_asr_tpu_torch.models import lm as tlm
from llm_guided_asr_tpu_torch.models import preencoder as tpre
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel
from llm_guided_asr_tpu_torch.models.llm_guided import resolve_llm_spec
from llm_guided_asr_tpu_torch.models.llm_guided_st import LLMGuidedSTModel
from llm_guided_asr_tpu_torch.tasks import asr as tasr
from llm_guided_asr_tpu_torch.tasks import st as tst
from test_torch_bf16 import GRAD_REL, OUT_REL, _f, check_bf16, check_grads, check_stats
from test_torch_bf16_models import relu_replayed_grads
from test_torch_st import CONFIG as ST_CONFIG
from test_torch_st import LLM_DIR, _jax_model
from test_torch_st import _batch as st_batch
from test_torch_streaming import BLOCK, ENCODER as STREAM_ENCODER
from test_torch_streaming import V as STREAM_V
from test_torch_streaming import _models as stream_models
from test_torch_train import NO_DROP_DEC, NO_DROP_ENC, _np, _torch_batch, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
TOKENS = ["<blank>", "<unk>"] + list("abcdefghi") + ["<sos/eos>"]
ENC = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=1,
           cnn_module_kernel=7, **NO_DROP_ENC)
DEC = dict(attention_heads=2, linear_units=24, num_blocks=1, **NO_DROP_DEC)
MEL = dict(n_fft=128, hop_length=64, n_mels=12)
TINY_W2V = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=48, conv_dim=[16, 16], conv_kernel=[10, 3], conv_stride=[5, 2],
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
MULTICHANNEL = dict(n_fft=64, hop_length=32, n_mels=8, mask_units=8, wpe_taps=3, wpe_delay=2,
                    wpe_iterations=2, ref_channel=1, use_wpe=True, use_beamformer=True)
ARGS = ("speech", "speech_lengths", "text", "text_lengths")


@pytest.fixture(autouse=True)
def _no_onednn(monkeypatch):
    """Every test here on ATen's own CPU convolutions: oneDNN's bfloat16
    ones return wrong results for some of these shapes (torch 2.13 on an
    AVX-512/AMX Xeon: a [3, 16, 50, 3] input through a 3 x 3 stride-2
    conv to width 1, or a [3, 32, 160] one in 4 groups of 8 channels, miss
    by the output's own size).  The card's path never meets oneDNN."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """config.json alone of a tiny HuBERT, wav2vec2 (layer-norm feature
    extractor, pre-norm layers) and Whisper: both packages read the trunk's
    widths from it, the weights are the test's seeded ones."""
    from transformers import HubertConfig, Wav2Vec2Config, WhisperConfig

    root = tmp_path_factory.mktemp("bf16_trunks")
    HubertConfig(**TINY_W2V).save_pretrained(root / "hubert")
    Wav2Vec2Config(**TINY_W2V, feat_extract_norm="layer", do_stable_layer_norm=True,
                   conv_bias=True).save_pretrained(root / "wav2vec2")
    WhisperConfig(d_model=16, encoder_layers=1, encoder_attention_heads=2, encoder_ffn_dim=24,
                  num_mel_bins=12, max_source_positions=64, decoder_layers=1,
                  decoder_attention_heads=2, decoder_ffn_dim=24).save_pretrained(root / "whisper")
    return root


def configs(root):
    base = {"token_list": TOKENS, "normalize": "utterance_mvn", "frontend_conf": MEL,
            "encoder_conf": dict(ENC), "decoder_conf": dict(DEC), "model_conf": {"ctc_weight": 0.3}}

    def hf(kind, **over):
        return {**base, "encoder": f"{kind}_hf", "encoder_conf": {
            "model_name_or_path": str(root / kind), "output_size": 16}, **over}

    raw = {"frontend": "none", "normalize": "none"}
    return {
        "ssl": {**base, "frontend": "ssl",
                "frontend_conf": {"model_name_or_path": str(root / "hubert"), "kind": "hubert"}},
        "hubert_hf": hf("hubert", **raw),
        "wav2vec2_hf": hf("wav2vec2", **raw),
        "whisper_hf": hf("whisper"),
        "avhubert": {**base, "encoder": "avhubert"},
        "sinc": {**base, "normalize": "none", "encoder_conf": dict(ENC, input_layer="linear"),
                 "frontend_conf": {"type": "sliding_window", "win_length": 400,
                                   "hop_length": 160},
                 "preencoder": "sinc", "preencoder_conf": {"out_channels": 16,
                                                           "sinc_channels": 8,
                                                           "dropout_rate": 0.0}},
        "fused": {**base, "frontend_conf": {"fused": [[128, 64, 12], [256, 128, 20]],
                                            "proj_dim": 8}},
        "multichannel": {**base, "frontend_conf": MULTICHANNEL},
        "contextual_block": {**base, "encoder": "contextual_block_conformer",
                             "encoder_conf": dict(ENC, block_size=4)},
    }


def _batch(seed, channels=0, s=3200):
    """3 utterances of s, s - 700 and s / 2 samples ([3, s] or [3, s,
    channels]) and labels of 4, 2 and 3 tokens."""
    rng = np.random.default_rng(seed)
    shape = (3, s, channels) if channels else (3, s)
    text = rng.integers(1, len(TOKENS) - 1, (3, 4)).astype(np.int32)
    lens = np.array([4, 2, 3], np.int32)
    return {"speech": (rng.standard_normal(shape) * 0.5).astype(np.float32),
            "speech_lengths": np.array([s, s - 700, s // 2], np.int32),
            "text": np.where(np.arange(4)[None] < lens[:, None], text, -1).astype(np.int32),
            "text_lengths": lens}


def _no_dropout(next_fun, args, kwargs, context):
    """flax interceptor: every Dropout the identity (the sinc blocks' first
    dropout is 0.1 whatever the config says)."""
    if context.method_name == "__call__" and isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _jax_step(jmodel, variables, batch, no_dropout=False):
    """JAX's training-mode losses and gradients on the port's names."""
    args = [jnp.asarray(batch[k]) for k in ARGS]

    def loss(params):
        with nn.intercept_methods(_no_dropout) if no_dropout else contextlib.nullcontext():
            (out, stats, _), _ = jmodel.apply(
                {**variables, "params": params}, *args, deterministic=False,
                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return out, stats

    (_, stats), grads = jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return {k: float(v) for k, v in stats.items()}, params_from_jax({"params": _np(grads)})


def assert_f32_state(model):
    """float32 parameters and buffers, the compute dtype saved nowhere."""
    assert {p.dtype for p in model.parameters()} == {F32}
    assert {b.dtype for n, b in model.named_buffers() if not n.endswith("compute")} <= {F32}
    assert not any(k.endswith("compute") for k in model.state_dict())


ASR_CASES = ["ssl", "hubert_hf", "wav2vec2_hf", "whisper_hf", "avhubert", "sinc", "fused",
             "multichannel", "contextual_block"]


@pytest.mark.parametrize("case", ASR_CASES)
def test_asr_model_bf16_loss_and_gradients_match_jax(hf_dirs, case, monkeypatch):
    """One training-mode step of the model the task builds for each choice
    in bfloat16 (``use_amp``): the losses and every float32 gradient by the
    three-part rule.  The frozen SSL frontend gets no gradient (JAX: zeros)
    and stays in eval mode; the sinc blocks' fixed dropout is off in both
    packages."""
    config = {**jasr.ASRTask.get_default_config(), **configs(hf_dirs)[case]}
    batch = _batch(1, channels=3 if case == "multichannel" else 0)
    jmodel = jasr.build_model(config)
    variables = seeded_variables(jmodel, *(jnp.asarray(batch[k]) for k in ARGS), seed=5)
    port = {dt: tasr.build_model({**config, "use_amp": dt == BF16}, "cpu") for dt in (BF16, F32)}
    for model in port.values():
        model.load_state_dict(params_from_jax(_np(variables)), strict=True)
    model = port[BF16].train()
    assert model.compute.dtype == BF16 and port[F32].compute.dtype == F32
    assert_f32_state(model)
    if case == "sinc":
        monkeypatch.setattr(tpre, "dropout", lambda x, rate, rng: x)
    jb_stats, jb_grads = _jax_step(jmodel.clone(dtype=jnp.bfloat16), variables, batch,
                                   case == "sinc")
    jf_stats, jf_grads = _jax_step(jmodel, variables, batch, case == "sinc")
    tb = _torch_batch(batch)
    loss, stats, _ = model(*tb.values())
    loss.backward()
    assert loss.dtype == F32
    check_stats(stats, jb_stats, jf_stats)
    frozen = "ssl_frontend."
    named = [(n, p) for n, p in model.named_parameters() if not n.startswith(frozen)]
    if case == "ssl":
        assert all(p.grad is None for n, p in model.named_parameters() if n.startswith(frozen))
        assert not any(g.numpy().any() for n, g in jb_grads.items() if n.startswith(frozen))
        assert not model.ssl_frontend.training
    keep = {n for n, _ in named}
    check_grads(named, {n: g for n, g in jb_grads.items() if n in keep},
                {n: g for n, g in jf_grads.items() if n in keep},
                gated=lambda: relu_replayed_grads(model, port[F32].train(),
                                                  lambda m: m(*tb.values())[0]))


def test_avhubert_audio_visual_forward_bf16_matches_jax():
    """The audio-visual encoder (video ResNet, concatenation, the trunk) on
    a ragged batch of features and 16 x 16 lip crops in bfloat16: the
    output's valid rows by the three-part rule."""
    av = dict(encoder_embed_dim=16, encoder_layers=1, encoder_attention_heads=2,
              encoder_ffn_embed_dim=24, dropout=0.0, resnet_channels=(8, 8, 8, 8),
              frontend_channels=8, conv_pos=16, conv_pos_groups=4, audio_only=False)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 7, 12)).astype(np.float32)
    video = rng.standard_normal((2, 7, 16, 16)).astype(np.float32)
    lens = np.array([7, 5], np.int32)
    jenc = javh.AVHubertEncoder(javh.AVHubertConfig(**av), 16)
    init = functools.partial(jenc.init, deterministic=True, video=jnp.asarray(video))
    variables = seeded_variables(types.SimpleNamespace(init=init), jnp.asarray(feats),
                                 jnp.asarray(lens), seed=4)
    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        out, _ = jit(functools.partial(jenc.clone(dtype=dt).apply, deterministic=True))(
            variables, jnp.asarray(feats), jnp.asarray(lens), video=jnp.asarray(video))
        want[dt] = _f(out)
    enc = tavh.AVHubertEncoder(tavh.AVHubertConfig(**av), 16, 12, device="cpu", dtype=BF16)
    enc.load_state_dict(params_from_jax(_np(variables)), strict=True)
    with torch.no_grad():
        got, got_lens = enc.eval()(torch.from_numpy(feats), torch.from_numpy(lens).long(),
                                   video=torch.from_numpy(video))
    assert got.dtype == BF16 and got_lens.tolist() == [7, 5]
    valid = np.arange(7)[None] < lens[:, None]
    check_bf16(got.float().numpy()[valid], want[jnp.bfloat16][valid], want[jnp.float32][valid],
               OUT_REL, "av out")


# ---------------------------------------------------------------------------
# streaming: the contextual-block encoder chunk by chunk, Speech2TextStreaming
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stream_bf16():
    """test_torch_streaming's model (global MVN, two blocks) with the
    port's bfloat16 twin and JAX's bfloat16 clone."""
    jmodel, variables, tmodel = stream_models()
    t16 = ASRModel(tmodel.cfg, device="cpu", dtype=BF16)
    t16.load_state_dict(tmodel.state_dict(), strict=True)
    return jmodel, variables, t16.eval()


def test_encode_chunk_bf16_matches_jax_and_the_offline_pass():
    """Three chunks of one block each through encode_chunk, the contexts
    carried in float32 from zeros (the recognizer's), the last chunk partly
    valid: each chunk's rows and the contexts by the three-part rule; the
    contexts come back float32 in both packages; the port's chunk rows
    equal its bfloat16 offline pass bit for bit."""
    _, variables, t16 = _stream_bf16()
    enc_vars = {"params": variables["params"]["encoder"]}
    rng = np.random.default_rng(27)
    feats = rng.standard_normal((1, 4 * 3 * BLOCK + 6, 20)).astype(np.float32)
    j_chunk = {dt: jit(functools.partial(
        JBlockEncoder(JConformerConfig(**STREAM_ENCODER), block_size=BLOCK, dtype=dt).apply,
        enc_vars, method=JBlockEncoder.encode_chunk)) for dt in (jnp.bfloat16, jnp.float32)}
    j_ctx = {dt: jnp.zeros((2, 1, 16), jnp.float32) for dt in j_chunk}
    t_ctx, rows = torch.zeros(2, 1, 16), []
    for blk, n_valid in enumerate((BLOCK, BLOCK, BLOCK - 3)):
        chunk = feats[:, 4 * BLOCK * blk: 4 * BLOCK * (blk + 1) + 6]
        j_out = {}
        for dt in j_chunk:
            j_out[dt], j_ctx[dt] = j_chunk[dt](jnp.asarray(chunk), j_ctx[dt],
                                               jnp.asarray(BLOCK * blk), jnp.asarray(n_valid))
        assert j_ctx[jnp.bfloat16].dtype == jnp.float32
        with torch.no_grad():
            out, t_ctx = t16.encoder.encode_chunk(torch.from_numpy(chunk), t_ctx, BLOCK * blk,
                                                  n_valid)
        assert out.dtype == BF16 and t_ctx.dtype == F32
        check_bf16(out.float().numpy(), _f(j_out[jnp.bfloat16]), _f(j_out[jnp.float32]),
                   OUT_REL, f"chunk {blk}")
        check_bf16(t_ctx.numpy(), _f(j_ctx[jnp.bfloat16]), _f(j_ctx[jnp.float32]), OUT_REL,
                   f"contexts {blk}")
        rows.append(out[:, :n_valid])
    n = 3 * BLOCK - 3
    with torch.no_grad():
        want, _ = t16.encoder(torch.from_numpy(feats).to(BF16)[:, :4 * n + 3],
                              torch.tensor([4 * n + 3]))
    assert torch.equal(torch.cat(rows, 1), want[:, :n])


def _jax_streaming(jmodel, variables, chunk_samples, beam_kw, monkeypatch):
    """The JAX Speech2TextStreaming around a Speech2Text stand-in made from
    the model object (tests/test_torch_streaming.py)."""
    s2t = object.__new__(jai.Speech2Text)
    s2t.model, s2t.variables = jmodel, variables
    s2t.maxlenratio, s2t.minlenratio, s2t.nbest = 0.0, 0.0, 1
    s2t._beam = JBeamSearch(jmodel, variables, vocab_size=STREAM_V, sos=STREAM_V - 1,
                            eos=STREAM_V - 1, **beam_kw)

    class Ids:
        def ids2tokens(self, ids):
            return [str(i) for i in ids]

        def tokens2text(self, tokens):
            return " ".join(tokens)

    s2t.converter = s2t.tokenizer = Ids()
    monkeypatch.setattr(jstream, "Speech2Text", lambda *a, **k: s2t)
    return jstream.Speech2TextStreaming(None, chunk_samples=chunk_samples)


def greedy_paths_agree(lp_port, lp_jax):
    """Whether the greedy CTC paths (frame argmaxes) of two packages'
    log-prob rows agree; where they part, every such frame must be a near
    tie: the port's log-probs of the two argmaxes within twice the
    packages' largest difference at that frame."""
    a, b = lp_port.argmax(-1), lp_jax.argmax(-1)
    for t in np.nonzero(a != b)[0]:
        gap = lp_port[t, a[t]] - lp_port[t, b[t]]
        assert gap <= 2 * np.abs(lp_port[t] - lp_jax[t]).max(), (t, gap)
    return bool((a == b).all())


def test_speech2text_streaming_bf16_matches_jax(monkeypatch):
    """A bfloat16 model streamed in 2,500-sample chunks: the final
    hypothesis equal to JAX's bfloat16 one and scored within 2e-2 of its
    size; each partial hypothesis too where the greedy CTC paths that set
    its token budget agree (where they part, the frames are near ties, so
    the budgets may differ by a token); the encoder rows and CTC log-probs
    kept float32, the carried contexts float32."""
    jmodel, variables, t16 = _stream_bf16()
    beam_kw = dict(beam_size=3, ctc_weight=0.3)
    wave = (np.random.default_rng(26).standard_normal(9000) * 0.3).astype(np.float32)
    jax_stream = _jax_streaming(jmodel.clone(dtype=jnp.bfloat16), variables, 2500, beam_kw,
                                monkeypatch)
    stream = Speech2TextStreaming(t16, chunk_samples=2500, **beam_kw)
    assert stream.incremental
    starts = list(range(0, len(wave), 2500))
    for start in starts:
        final = start == starts[-1]
        chunk = wave[start: start + 2500]
        _, _, w_ids, w_hyp = jax_stream(chunk, is_final=final)[0]
        if not final:
            j_rows = np.asarray(jax_stream._ctc_logp[: jax_stream._sub_done])
        ids, hyp = stream(chunk, is_final=final)[0]
        if not final:
            assert stream._ctxs.dtype == stream._enc.dtype == stream._ctc_logp.dtype == F32
            t_rows = stream._ctc_logp[: stream._sub_done].numpy()
            if not greedy_paths_agree(t_rows, j_rows):
                continue
        assert ids == w_ids
        assert abs(hyp.score - w_hyp.score) <= OUT_REL * max(1.0, abs(w_hyp.score))
    assert len(ids) > 2


# ---------------------------------------------------------------------------
# ST and the LMs (bfloat16 from code, as in JAX)
# ---------------------------------------------------------------------------

def test_st_model_bf16_loss_and_gradients_match_jax(monkeypatch):
    """The ST model (extra ASR decoder, mtlalpha 0.5) built by
    ``build_st_model(config, device, bfloat16)``, eval mode: the losses and
    every gradient but the frozen LLM's (none in either) by the three-part
    rule.  On random weights the source CTC head ties near the top at
    some frames, so bfloat16's greedy first pass (the LLM's prompt) can
    part from float32's; where it does, the frames must be near ties
    (:func:`greedy_paths_agree`).  All four runs then read one prompt:
    the port's float32 model's greedy hypothesis, which the port's
    bfloat16 run takes in place of its own first pass (as chip_smoke.py's
    ``pinned_first_pass`` does) and both JAX runs take as the CTC
    log-probs their greedy first pass reads."""
    spec = resolve_llm_spec(ST_CONFIG["llm_conf"])
    jmodel = _jax_model(spec)
    batch = st_batch()
    args = [jnp.asarray(batch[k]) for k in tst.ST_BATCH_ARGS]
    variables = seeded_variables(jmodel, *args, seed=0)
    llm = stream_llm_params(LLM_DIR, jmodel.cfg.llm, dtype=jnp.float32)
    variables = {**variables, "params": {**variables["params"], "llm": llm}}

    port = {}
    for dt in (BF16, F32):
        port[dt] = tst.build_st_model({**ST_CONFIG, "device": "cpu"}, "cpu", dt).eval()
        port[dt].load_state_dict(params_from_jax(_np(variables)), strict=True)
    model = port[BF16]
    assert model.compute.dtype == BF16
    assert_f32_state(model)
    targs = [torch.from_numpy(batch[k]) if batch[k].dtype == np.float32
             else torch.from_numpy(batch[k]).long() for k in tst.ST_BATCH_ARGS]
    # the first pass pinned to the float32 model's hypothesis, once the
    # greedy paths are shown to part at near ties alone
    with torch.no_grad():
        enc32, lens = port[F32].encode(*targs[:2])
        pinned = port[F32]._first_pass_hyp(enc32, lens)
        enc16, _ = model.encode(*targs[:2])
        lp32, lp16 = port[F32].ctc_log_softmax(enc32), model.ctc_log_softmax(enc16)
    for b_, n in enumerate(lens.tolist()):
        greedy_paths_agree(lp16[b_, :n].numpy(), lp32[b_, :n].numpy())
    monkeypatch.setattr(LLMGuidedSTModel, "_first_pass_hyp", lambda self, e, l: pinned)

    pins = []

    def pin_jax(next_fun, args_, kwargs, context):
        """JAX's ST first pass (decoder_logits' greedy decode of
        ctc_log_softmax, which nothing else reads) on lp32."""
        if context.method_name == "ctc_log_softmax":
            pins.append(context.module.dtype)
            return jnp.asarray(lp32.numpy())
        return next_fun(*args_, **kwargs)

    def j_run(model):
        def loss(params):
            with nn.intercept_methods(pin_jax):
                out, stats, _ = model.apply({**variables, "params": params}, *args)
            return out, stats
        (_, stats), grads = jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
        return {k: float(v) for k, v in stats.items()}, params_from_jax({"params": _np(grads)})

    (jb_stats, jb_grads), (jf_stats, jf_grads) = (
        j_run(jmodel.clone(dtype=jnp.bfloat16)), j_run(jmodel))
    assert pins == [jnp.bfloat16, jnp.float32]
    loss, stats, _ = model(*targs)
    loss.backward()
    check_stats(stats, jb_stats, jf_stats)
    named = [(n, p) for n, p in model.named_parameters() if not n.startswith("llm.")]
    assert all(p.grad is None for n, p in model.named_parameters() if n.startswith("llm."))
    keep = {n for n, _ in named}
    check_grads(named, {n: g for n, g in jb_grads.items() if n in keep},
                {n: g for n, g in jf_grads.items() if n in keep},
                gated=lambda: relu_replayed_grads(model, port[F32], lambda m: m(*targs)[0]))


LM_V = 11
LM_TOKENS = np.array([[10, 3, 4, 7, 1, 2], [10, 5, 9, 0, 0, 0], [10, 2, 2, 8, 6, 0]], np.int64)
LM_LENGTHS = np.array([6, 3, 5], np.int64)
LM_CONFIGS = {
    "transformer": lambda m: m.TransformerLMConfig(vocab_size=LM_V, embed_unit=16, att_unit=32,
                                                   head=2, unit=48, layer=1, dropout_rate=0.0),
    "lstm": lambda m: m.SequentialRNNLMConfig(vocab_size=LM_V, unit=24, nlayers=2,
                                              rnn_type="lstm"),
    "gru": lambda m: m.SequentialRNNLMConfig(vocab_size=LM_V, unit=24, nlayers=1,
                                             rnn_type="gru"),
}


@pytest.mark.parametrize("kind", sorted(LM_CONFIGS))
def test_lm_bf16_nll_scores_and_gradients_match_jax(kind):
    """The LM in bfloat16 (the RNN cells in float32, as flax promotes
    them): the per-utterance NLL, the beam-search scorer's log-probs and
    every gradient of the mean NLL by the three-part rule; the logits the
    LM returns are float32."""
    jcls = jlm.TransformerLM if kind == "transformer" else jlm.SequentialRNNLM
    tcls = tlm.TransformerLM if kind == "transformer" else tlm.SequentialRNNLM
    jmodels = {dt: jlm.ESPnetLanguageModel(lm=jcls(LM_CONFIGS[kind](jlm), dtype=dt),
                                           vocab_size=LM_V) for dt in (jnp.bfloat16, jnp.float32)}
    toks, lens = jnp.asarray(LM_TOKENS, jnp.int32), jnp.asarray(LM_LENGTHS, jnp.int32)
    variables = seeded_variables(jmodels[jnp.float32], toks, lens, seed=5)
    text = np.where(np.arange(6)[None] < LM_LENGTHS[:, None], LM_TOKENS, -1)

    def j_run(jmodel):
        def loss(params):
            out, _, _ = jmodel.apply({"params": params}, jnp.asarray(text, jnp.int32), lens)
            return out
        nll, _ = jit(functools.partial(jmodel.apply, method=jmodel.nll))(
            variables, jnp.asarray(text, jnp.int32), lens)
        score = jit(jlm.make_lm_score_fn(jmodel.lm, {"params": variables["params"]["lm"]}))(
            toks, lens)
        grads = jit(jax.grad(loss))(variables["params"])
        return _f(nll), _f(score), params_from_jax({"params": _np(grads)})

    (jb_nll, jb_score, jb_grads), (jf_nll, jf_score, jf_grads) = (
        j_run(jmodels[jnp.bfloat16]), j_run(jmodels[jnp.float32]))
    model = tlm.ESPnetLanguageModel(tcls(LM_CONFIGS[kind](tlm), device="cpu", dtype=BF16), LM_V)
    model.load_state_dict(params_from_jax(_np(variables)), strict=True)
    model.eval()
    assert model.compute.dtype == BF16
    assert_f32_state(model)
    with torch.no_grad():
        logits = model.lm(torch.from_numpy(LM_TOKENS), torch.from_numpy(LM_LENGTHS))
        nll, _ = model.nll(torch.from_numpy(text), torch.from_numpy(LM_LENGTHS))
        score = tlm.make_lm_score_fn(model.lm)(torch.from_numpy(LM_TOKENS),
                                               torch.from_numpy(LM_LENGTHS))
    assert logits.dtype == nll.dtype == score.dtype == F32
    check_bf16(nll.numpy(), jb_nll, jf_nll, OUT_REL, "nll")
    check_bf16(score.numpy(), jb_score, jf_score, OUT_REL, "scores")
    model(torch.from_numpy(text), torch.from_numpy(LM_LENGTHS))[0].backward()
    check_grads(list(model.named_parameters()), jb_grads, jf_grads, GRAD_REL)


def test_st_and_lm_tasks_keep_float32_by_default():
    """As in JAX, the ST and LM tasks build float32 unless code passes a
    dtype (``train_dtype`` is not read for them)."""
    from llm_guided_asr_tpu_torch.tasks import lm as tlm_task

    st = tst.build_st_model({**ST_CONFIG, "device": "cpu", "use_amp": True}, "cpu")
    lm = tlm_task.build_lm({"token_list": TOKENS, "lm": "seq_rnn", "use_amp": True,
                            "lm_conf": {"unit": 8, "nlayers": 1}}, "cpu")
    assert st.compute.dtype == lm.compute.dtype == F32
