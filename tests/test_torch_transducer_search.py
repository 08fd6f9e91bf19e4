"""Port vs JAX, the transducer's searches: greedy decoding and the
fixed-expansion beam search (beam 4 and 5), on the models of
tests/test_torch_transducer.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models import transducer as jtd
from llm_guided_asr_tpu.search.transducer_beam import transducer_beam_decode as j_beam
from llm_guided_asr_tpu_torch.models import transducer as ttd
from llm_guided_asr_tpu_torch.search.transducer_beam import transducer_beam_decode
from test_torch_transducer import _batch, _encode, _models


@pytest.mark.parametrize("decoder_type", ["stateless", "rwkv"])
def test_greedy_decode_matches_jax(decoder_type):
    jmodel, variables, tmodel = _models(decoder_type)
    batch = _batch(2)
    (enc, enc_lens), (tenc, tlens) = _encode(decoder_type, batch["speech"],
                                             batch["speech_lengths"])
    jtok, jn = jtd.transducer_greedy_decode(jmodel, variables, enc, enc_lens)
    with torch.no_grad():
        tok, n = ttd.transducer_greedy_decode(tmodel, tenc, tlens)
    assert n.tolist() == np.asarray(jn).tolist() and int(n.sum()) > 0
    for b in range(2):
        assert tok[b, : n[b]].tolist() == np.asarray(jtok)[b, : int(jn[b])].tolist()


@pytest.mark.parametrize("decoder_type,beam", [("stateless", 4), ("rwkv", 4), ("rwkv", 5)])
def test_beam_decode_matches_jax(decoder_type, beam):
    """Beam 4, and beam 5 (the serving default): the 4-best lists hold the
    same token sequences in the same order, scores at 1e-4."""
    jmodel, variables, tmodel = _models(decoder_type)
    speech = _batch(3)["speech"][:1]
    lengths = np.array([1600], np.int32)
    (enc, enc_lens), (tenc, tlens) = _encode(decoder_type, speech, lengths)
    jh = j_beam(jmodel, variables, enc, enc_lens, beam_size=beam, nbest=4)
    with torch.no_grad():
        th = transducer_beam_decode(tmodel, tenc, tlens, beam_size=beam, nbest=4)
    assert len(th) == 4 and any(h.yseq for h in th)
    assert [h.yseq for h in th] == [h.yseq for h in jh]
    np.testing.assert_allclose([h.score for h in th], [h.score for h in jh], rtol=1e-4)
    assert all(np.isfinite(h.score) for h in th)
