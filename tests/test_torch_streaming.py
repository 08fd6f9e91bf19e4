"""Port vs JAX: streaming -- the contextual-block Conformer (offline and
chunk by chunk), the CTC rows' extension over new frames, the resumable
beam search, Speech2TextStreaming on a tiny global-MVN model, and the
frame-synchronous CTC beam search."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_inference as jai
from llm_guided_asr_tpu.bin import asr_inference_streaming as jstream
from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.streaming import ContextualBlockConformerEncoder as JBlockEncoder
from llm_guided_asr_tpu.models.transformer_decoder import TransformerDecoderConfig as JDecConfig
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.search import ctc_prefix as jcp
from llm_guided_asr_tpu.search.beam_search import BatchBeamSearch as JBeamSearch
from llm_guided_asr_tpu.search.timesync import CTCBeamSearchTimesync as JTimesync
from llm_guided_asr_tpu_torch.bin.asr_inference import Speech2Text
from llm_guided_asr_tpu_torch.bin.asr_inference_streaming import Speech2TextStreaming
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.streaming import ContextualBlockConformerEncoder
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.search import ctc_prefix as tcp
from llm_guided_asr_tpu_torch.search.beam_search import BatchBeamSearch
from llm_guided_asr_tpu_torch.search.timesync import CTCBeamSearchTimesync
from test_torch_train import jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

V, BLOCK = 9, 8  # sos = eos = 8
FRONTEND = dict(n_fft=128, hop_length=64, n_mels=20)
ENCODER = dict(output_size=16, attention_heads=2, linear_units=24, num_blocks=2,
               macaron_style=True, use_cnn_module=True, cnn_module_kernel=5, block_size=BLOCK,
               dropout_rate=0.0, positional_dropout_rate=0.0, attention_dropout_rate=0.0)
DECODER = dict(attention_heads=2, linear_units=24, num_blocks=1, dropout_rate=0.0,
               positional_dropout_rate=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX ASRModel, its variables, the port's) with the contextual-block
    encoder, global MVN (seeded statistics) and seeded weights."""
    common = dict(vocab_size=V, normalize="global_mvn", encoder_type="contextual_block_conformer",
                  ctc_weight=0.3)
    jmodel = JASRModel(JASRModelConfig(frontend=JFrontendConfig(**FRONTEND),
                                       encoder=JConformerConfig(**ENCODER),
                                       decoder=JDecConfig(**DECODER), **common))
    variables = seeded_variables(jmodel, jnp.zeros((1, 4000)), jnp.asarray([4000]),
                                 jnp.ones((1, 3), jnp.int32), jnp.asarray([3]), seed=21)
    tmodel = ASRModel(ASRModelConfig(frontend=FrontendConfig(**FRONTEND),
                                     encoder=ConformerConfig(**ENCODER),
                                     decoder=TransformerDecoderConfig(**DECODER), **common),
                      device="cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    return jmodel, variables, tmodel.eval()


def test_contextual_block_encoder_matches_jax():
    """The offline pass over a ragged batch (with a block that has no valid
    frame), then encode_chunk at block 2 with carried contexts and a
    partly valid chunk, against the JAX module (1e-5)."""
    _, variables, tmodel = _models()
    assert isinstance(tmodel.encoder, ContextualBlockConformerEncoder)
    jenc = JBlockEncoder(JConformerConfig(**ENCODER), block_size=BLOCK)
    rng = np.random.default_rng(22)
    feats = rng.standard_normal((2, 83, 20)).astype(np.float32)
    lens = np.array([83, 30], np.int32)  # 20 and 8 sub-frames of 20: 3 blocks of 8
    enc_vars = {"params": variables["params"]["encoder"]}
    j_out, j_lens = jit(lambda f, n: jenc.apply(enc_vars, f, n))(
        jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        t_out, t_lens = tmodel.encoder(torch.from_numpy(feats), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)

    m = 2 * BLOCK
    chunk = rng.standard_normal((2, 4 * m + 6, 20)).astype(np.float32)
    ctxs = rng.standard_normal((2, 2, 16)).astype(np.float32)

    def j_chunk(f, c, off, nv):
        return jenc.apply(enc_vars, f, c, off, nv, method=JBlockEncoder.encode_chunk)

    for off, n_valid in ((2 * BLOCK, m), (3 * BLOCK, 11), (4990, m)):  # the last clips the table
        j_x, j_ctx = jit(j_chunk)(jnp.asarray(chunk), jnp.asarray(ctxs), jnp.asarray(off),
                                      jnp.asarray(n_valid))
        with torch.no_grad():
            t_x, t_ctx = tmodel.encoder.encode_chunk(torch.from_numpy(chunk),
                                                     torch.from_numpy(ctxs), off, n_valid)
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), **TOL)
        np.testing.assert_allclose(t_ctx.numpy(), np.asarray(j_ctx), **TOL)
    with pytest.raises(ValueError, match="multiple of block_size"):
        tmodel.encoder.encode_chunk(torch.zeros(1, 4 * 5 + 6, 20), torch.from_numpy(ctxs[:, :1]),
                                    0, 5)


@pytest.mark.parametrize("input_layer", ["linear", "none"])
def test_contextual_block_input_layers_match_jax(input_layer):
    """The offline pass under ``input_layer`` linear (one Dense to 16) and
    none (the layers at the features' width, 12) on a ragged batch, one
    layer, against the JAX module (1e-5); encode_chunk refuses both, as in
    JAX."""
    cfg = {**ENCODER, "input_layer": input_layer, "num_blocks": 1}
    jenc = JBlockEncoder(JConformerConfig(**cfg), block_size=BLOCK)
    rng = np.random.default_rng(23)
    feats = rng.standard_normal((2, 21, 12)).astype(np.float32)
    lens = np.array([21, 9], np.int32)
    variables = seeded_variables(jenc, jnp.asarray(feats), jnp.asarray(lens), seed=24)
    j_out, j_lens = jit(lambda f, n: jenc.apply(variables, f, n))(jnp.asarray(feats),
                                                                      jnp.asarray(lens))
    tenc = ContextualBlockConformerEncoder(ConformerConfig(**cfg), 12, block_size=BLOCK,
                                           device="cpu")
    tenc.load_state_dict(params_from_jax(_np(variables)), strict=True)
    assert tenc.output_size == (16 if input_layer == "linear" else 12) == j_out.shape[-1]
    with torch.no_grad():
        t_out, t_lens = tenc.eval()(torch.from_numpy(feats), torch.from_numpy(lens).long())
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    with pytest.raises(NotImplementedError, match="conv2d"):
        tenc.encode_chunk(torch.zeros(1, 4 * BLOCK + 6, 12), torch.zeros(2, 1, 12), 0, BLOCK)


def test_encode_chunk_equals_offline_encode():
    """Feeding an utterance's features block by block with the carried
    contexts gives the offline rows (the positions and the feature offset
    4 * pos_offset line up)."""
    _, _, tmodel = _models()
    rng = np.random.default_rng(23)
    feats = torch.from_numpy(rng.standard_normal((1, 4 * 3 * BLOCK + 6, 20)).astype(np.float32))
    with torch.no_grad():
        want, _ = tmodel.encoder(feats, torch.tensor([feats.shape[1]]))
        ctxs, rows = torch.zeros(2, 1, 16), []
        for blk in range(3):
            chunk = feats[:, 4 * BLOCK * blk: 4 * BLOCK * (blk + 1) + 6]
            out, ctxs = tmodel.encoder.encode_chunk(chunk, ctxs, BLOCK * blk, BLOCK)
            rows.append(out)
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), want[:, :3 * BLOCK].numpy(), **TOL)


def test_ctc_prefix_extend_matches_jax():
    """From the empty prefix (old length 0 and > 0) and from advanced
    hypotheses (JAX's states, given to both), against the JAX function
    (the two cumulative sums associate differently: rtol 1e-6)."""
    rng = np.random.default_rng(24)
    t_max, k = 23, 3
    logp = jnp.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((t_max, V)) * 2), -1))
    t_logp = torch.from_numpy(np.array(logp))[None]
    init = jcp.ctc_prefix_init(logp, jnp.asarray(9), k)
    adv = jcp.ctc_prefix_advance(logp, jnp.asarray(9), init, jnp.asarray([3, 4, 3]),
                                 jnp.asarray([0, 0, 0]), jnp.zeros(k))
    for js, (old, new) in ((init, (0, 9)), (init, (9, 17)), (adv, (9, 23))):
        ts = tcp.CTCPrefixState(*(torch.from_numpy(np.array(a))[None] for a in js))
        want = jcp.ctc_prefix_extend(js, logp, jnp.asarray(old), jnp.asarray(new))
        got = tcp.ctc_prefix_extend(ts, t_logp, torch.tensor([old]), torch.tensor([new]))
        np.testing.assert_allclose(got.r.numpy()[0], np.asarray(want.r), rtol=1e-6, atol=0)
        assert torch.equal(got.psi, ts.psi) and torch.equal(got.last, ts.last)
    # two lanes with different old and new lengths: each lane as if alone
    ts = tcp.CTCPrefixState(*(torch.from_numpy(np.array(a))[None].repeat(2, *[1] * a.ndim)
                              for a in adv))
    both = tcp.ctc_prefix_extend(ts, t_logp.repeat(2, 1, 1), torch.tensor([9, 12]),
                                 torch.tensor([23, 17]))
    for lane, (old, new) in enumerate(((9, 23), (12, 17))):
        want = jcp.ctc_prefix_extend(adv, logp, jnp.asarray(old), jnp.asarray(new))
        np.testing.assert_allclose(both.r.numpy()[lane], np.asarray(want.r), rtol=1e-6, atol=0)


def _enc(seed, t=29, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, t, d)) * 2.0).astype(np.float32)


def test_stream_search_matches_jax():
    """stream_start / stream_step / stream_hyps over 3 cuts of one encoder
    output (buffers at full width, rows past the cut zeroed, the budget
    between cuts the CTC-greedy count of the trusted frames): the partial
    and final hypotheses and scores (1e-4) against JAX."""
    jmodel, variables, tmodel = _models()
    common = dict(vocab_size=V, sos=8, eos=8, beam_size=3, ctc_weight=0.3)
    j_bs, t_bs = JBeamSearch(jmodel, variables, **common), BatchBeamSearch(tmodel, **common)
    enc = _enc(25)
    t = enc.shape[1]
    with torch.no_grad():
        logp = tmodel.ctc_log_softmax(torch.from_numpy(enc))[0]
    rows = np.arange(t)
    j_carry = t_carry = None
    prev = 0
    for ci, (cut, maxlen) in enumerate(((10, 0), (20, 3), (29, 29))):
        enc_buf = np.where((rows < cut)[None, :, None], enc, 0.0).astype(np.float32)
        ctc_buf = logp.masked_fill(~torch.from_numpy(rows < cut)[:, None], 0.0)
        if ci == 0:
            j_carry = j_bs.stream_start(jnp.asarray(ctc_buf.numpy()), jnp.asarray(enc_buf),
                                        jnp.asarray(cut), t + 2)
            t_carry = t_bs.stream_start(ctc_buf, torch.from_numpy(enc_buf), cut, t + 2)
        j_carry = j_bs.stream_step(jnp.asarray(enc_buf), jnp.asarray(prev), jnp.asarray(cut),
                                   jnp.asarray(maxlen), jnp.asarray(0), j_carry,
                                   jnp.asarray(ctc_buf.numpy()))
        t_carry = t_bs.stream_step(torch.from_numpy(enc_buf), prev, cut, maxlen, 0, t_carry,
                                   ctc_buf)
        prev = cut
        want, got = j_bs.stream_hyps(j_carry, nbest=3), t_bs.stream_hyps(t_carry, nbest=3)
        assert [h.yseq for h in got] == [h.yseq for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], atol=1e-4)
        assert t_carry[0].step == int(j_carry[0].step)
    assert len(got[0].yseq) > 3


def _jax_streaming(chunk_samples, beam_kw, monkeypatch):
    """The JAX Speech2TextStreaming around a Speech2Text made from the
    model object (the JAX constructor reads a config file and checkpoint:
    its Speech2Text is replaced by this stand-in)."""
    jmodel, variables, _ = _models()
    s2t = object.__new__(jai.Speech2Text)
    s2t.model, s2t.variables = jmodel, variables
    s2t.maxlenratio, s2t.minlenratio, s2t.nbest = 0.0, 0.0, 1
    s2t._beam = JBeamSearch(jmodel, variables, vocab_size=V, sos=8, eos=8, **beam_kw)

    class Ids:
        def ids2tokens(self, ids):
            return [str(i) for i in ids]

        def tokens2text(self, tokens):
            return " ".join(tokens)

    s2t.converter = s2t.tokenizer = Ids()
    monkeypatch.setattr(jstream, "Speech2Text", lambda *a, **k: s2t)
    return jstream.Speech2TextStreaming(None, chunk_samples=chunk_samples)


def test_speech2text_streaming_matches_jax(monkeypatch):
    """decode_utterance chunk by chunk: each chunk's partial hypothesis and
    score (1e-4) against JAX, the encoder rows equal to the offline encode
    (1e-5), and utterance MVN refused when incremental streaming is asked
    for."""
    _, _, tmodel = _models()
    beam_kw = dict(beam_size=3, ctc_weight=0.3)
    wave = (np.random.default_rng(26).standard_normal(9000) * 0.3).astype(np.float32)
    jst = _jax_streaming(2500, beam_kw, monkeypatch)
    want = jst.decode_utterance(wave)
    tst = Speech2TextStreaming(tmodel, chunk_samples=2500, **beam_kw)
    got = tst.decode_utterance(wave)
    assert len(got) == len(want) == 4
    for (ids, hyp), (_, _, w_ids, w_hyp) in zip((g[0] for g in got), (w[0] for w in want)):
        assert ids == w_ids
        np.testing.assert_allclose(hyp.score, w_hyp.score, atol=1e-4)
    assert len(got[-1][0][0]) > 2

    # the encoder rows of the stream against the offline encode
    for start in range(0, len(wave), 2500):
        tst._buffer = np.concatenate([tst._buffer, wave[start: start + 2500]])
        with torch.inference_mode():
            tst._advance(start + 2500 >= len(wave))
    padded = np.zeros(9600, np.float32)  # Speech2Text's bucket of 1600 samples
    padded[: len(wave)] = wave
    with torch.no_grad():
        enc, lens = tmodel.encode(torch.from_numpy(padded[None]), torch.tensor([len(wave)]))
    assert tst._sub_done == int(lens[0])
    np.testing.assert_allclose(tst._enc[: tst._sub_done].numpy(), enc[0, : tst._sub_done].numpy(),
                               **TOL)
    offline = Speech2Text.from_model(tmodel, speech_pad_multiple=1600, **beam_kw)(wave)[0]
    assert offline[0] == got[-1][0][0]

    import dataclasses

    umvn = ASRModel(dataclasses.replace(tmodel.cfg, normalize="utterance_mvn"), device="cpu")
    with pytest.raises(ValueError, match="utterance_mvn"):
        Speech2TextStreaming(umvn, incremental=True, **beam_kw)


def test_reencode_fallback_decodes_the_buffer_so_far():
    """A model that cannot stream incrementally (utterance MVN) re-decodes
    the buffer so far at every chunk, as JAX's fallback does: each chunk's
    result is Speech2Text's on the prefix, the last one the whole
    utterance's."""
    import dataclasses

    tmodel = _models()[2]
    umvn = ASRModel(dataclasses.replace(tmodel.cfg, normalize="utterance_mvn"), device="cpu")
    umvn.load_state_dict({k: v for k, v in tmodel.state_dict().items() if not k.startswith("mvn_")})
    beam_kw = dict(beam_size=3, ctc_weight=0.3)
    stream = Speech2TextStreaming(umvn, chunk_samples=2500, **beam_kw)
    assert not stream.incremental
    wave = (np.random.default_rng(27).standard_normal(6000) * 0.3).astype(np.float32)
    got = stream.decode_utterance(wave)
    offline = Speech2Text.from_model(umvn, **beam_kw)
    assert len(got) == 3
    for i, part in enumerate(got):
        want = offline(wave[: 2500 * (i + 1)])
        assert [r[0] for r in part] == [r[0] for r in want]
        assert part[0][1].score == want[0][1].score
    assert len(stream._buffer) == 0  # the final chunk resets the stream


@pytest.mark.parametrize("att_weight", [0.0, 0.4])
def test_ctc_timesync_matches_jax(att_weight):
    """CTC-only against JAX (hypotheses, scores 1e-4); with the attention
    rescoring, the CTC part against JAX and the decoder part against the
    teacher-forced JAX decoder over [sos, y] -> [y, eos]."""
    jmodel, variables, tmodel = _models()
    kw = dict(vocab_size=V, sos=8, eos=8, beam_size=4, ctc_weight=1.0 - att_weight,
              att_weight=att_weight)
    enc = _enc(27, t=17)
    enc_lens = np.array([14])
    want = JTimesync(jmodel, variables, **kw)(jnp.asarray(enc), jnp.asarray(enc_lens), nbest=4)
    got = CTCBeamSearchTimesync(tmodel, **kw)(torch.from_numpy(enc), torch.from_numpy(enc_lens),
                                              nbest=4)
    if att_weight == 0.0:
        assert [h.yseq for h in got] == [h.yseq for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want], atol=1e-4)
        return
    decoder_logits = jit(functools.partial(jmodel.apply, method=jmodel.decoder_logits))
    for h in got:  # a prefix may sit on two slots (paths are not merged, as in JAX)
        assert any(w.yseq == h.yseq and abs(w.scores["ctc"] - h.scores["ctc"]) <= 1e-4
                   for w in want)
        ys = jnp.asarray([[8] + h.yseq])
        logits = decoder_logits(variables, jnp.asarray(enc), jnp.asarray(enc_lens), ys,
                                jnp.asarray([len(h.yseq) + 1]))
        lp = np.asarray(jax.nn.log_softmax(logits[0], -1))
        dec = sum(lp[i, t] for i, t in enumerate(h.yseq + [8]))
        np.testing.assert_allclose(h.scores["decoder"], dec, atol=1e-4)
        np.testing.assert_allclose(h.score, (1 - att_weight) * h.scores["ctc"]
                                   + att_weight * dec, atol=1e-4)
