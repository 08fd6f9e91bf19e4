"""Port vs JAX: STFT power, log-mel, MVN and the whole default frontend."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.ops import frontend as jfe
from llm_guided_asr_tpu_torch.ops import frontend as tfe

torch.set_num_threads(1)


def _speech(seed=0):
    rng = np.random.default_rng(seed)
    speech = (rng.standard_normal((3, 4000)) * 0.1).astype(np.float32)
    lengths = np.array([4000, 3100, 1234], np.int32)
    return speech, lengths


def test_mel_filterbank_matches_jax():
    for kw in (dict(), dict(n_fft=256, n_mels=23), dict(fmin=20.0, fmax=7600.0, htk=True)):
        np.testing.assert_array_equal(tfe.mel_filterbank(**kw), jfe.mel_filterbank(**kw))


@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, None), (400, 160, 320)])
def test_stft_power_matches_jax(n_fft, hop, win):
    speech, _ = _speech(1)
    ref = np.asarray(jfe.stft_power(jnp.asarray(speech), n_fft, win, hop))
    out = tfe.stft_power(torch.from_numpy(speech), n_fft, win, hop).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_default_frontend_and_mvn_match_jax():
    speech, lengths = _speech(2)
    j_feats, j_lens = jfe.default_frontend(jnp.asarray(speech), jnp.asarray(lengths), n_mels=40)
    t_feats, t_lens = tfe.default_frontend(torch.from_numpy(speech),
                                           torch.from_numpy(lengths).long(), n_mels=40)
    np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
    np.testing.assert_allclose(t_feats.numpy(), np.asarray(j_feats), rtol=1e-4, atol=1e-4)

    for kw in (dict(), dict(norm_vars=True), dict(norm_means=False, norm_vars=True)):
        ref = np.asarray(jfe.utterance_mvn(j_feats, j_lens, **kw))
        out = tfe.utterance_mvn(torch.from_numpy(np.array(j_feats)), t_lens, **kw).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)

    rng = np.random.default_rng(3)
    mean = rng.standard_normal(40).astype(np.float32)
    inv_std = rng.uniform(0.5, 2.0, 40).astype(np.float32)
    ref = np.asarray(jfe.global_mvn(j_feats, jnp.asarray(mean), jnp.asarray(inv_std), j_lens))
    out = tfe.global_mvn(torch.from_numpy(np.array(j_feats)), torch.from_numpy(mean),
                         torch.from_numpy(inv_std), t_lens).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
