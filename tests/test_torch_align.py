"""Port vs JAX, CTC forced alignment: ``ctc_forced_align`` of
ops/ctc_align.py gives JAX's state and token paths exactly (random
posteriors, posteriors rounded to whole nats so that the (stay, diagonal,
skip) choices tie, repeated tokens, ``t_len`` < T, one frame), and
``token_boundaries`` JAX's bounds; the ``asr_align`` CLI writes JAX's
``segments`` and ``aligned`` files byte for byte from one JAX-written
experiment directory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.bin import asr_align as jalign
from llm_guided_asr_tpu.ops import ctc_align as jca
from llm_guided_asr_tpu.tasks import asr as jasr
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu.train.checkpoint import save_pytree
from llm_guided_asr_tpu.utils import config as jconfig
from llm_guided_asr_tpu_torch.bin import asr_align
from llm_guided_asr_tpu_torch.data.fileio import write_wav
from llm_guided_asr_tpu_torch.ops import ctc_align as tca
from test_torch_branchformer import _batch, _fast_jax_init, _task_config
from test_torch_train import jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)


T_MAX = 24
_JAX_ALIGN = jit(jca.ctc_forced_align)  # one compile a (T, U) shape


def _case(seed, ties, repeat, t=T_MAX):
    """logp [t, 6], 1 or 4 tokens, a t_len in [1, t]."""
    rng = np.random.default_rng(seed)
    logp = np.log(rng.dirichlet(np.ones(6), size=t)).astype(np.float32)
    if ties:
        logp = np.round(logp).astype(np.float32)
    tokens = rng.integers(1, 6, size=min(1 + 3 * (seed % 2), t)).astype(np.int32)
    if repeat:
        tokens[1:] = tokens[:-1]  # every token repeats its predecessor
    return logp, tokens, int(rng.integers(1, t + 1))


def _check(logp, tokens, t_len):
    want = _JAX_ALIGN(jnp.asarray(logp), jnp.asarray(tokens), jnp.asarray(t_len))
    got = tca.ctc_forced_align(torch.from_numpy(logp), torch.from_numpy(tokens), t_len)
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist(), t_len
    assert (tca.token_boundaries(got[1], len(tokens))
            == jca.token_boundaries(np.asarray(want[1]), len(tokens))).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("repeat", [False, True])
def test_forced_alignment_matches_jax(ties, repeat):
    for seed in range(24):
        logp, tokens, t_len = _case(seed, ties, repeat)
        _check(logp, tokens, t_len)
        _check(logp, tokens, T_MAX)
    _check(*_case(0, ties, repeat, t=1))  # one frame


def test_token_boundaries_fill_a_token_no_frame_holds():
    got = tca.token_boundaries(np.array([-1, 0, 0, -1, 2, -1]), 3)
    assert got.tolist() == jca.token_boundaries(np.array([-1, 0, 0, -1, 2, -1]), 3).tolist()
    assert got.tolist() == [[1, 3], [3, 3], [4, 5]]


def test_asr_align_writes_jax_s_files(tmp_path, monkeypatch):
    monkeypatch.setattr(jasr, "init_model_variables", _fast_jax_init)
    config = _task_config(tmp_path, "transformer")
    jconfig.dump_yaml(config, tmp_path / "config.yaml")
    jmodel = jasr.build_model(config)
    batch = _batch(np.random.default_rng(0))
    variables = seeded_variables(jmodel, *(jnp.asarray(batch[k])
                                           for k in jtrainer.DEFAULT_BATCH_ARGS), seed=8)
    save_pytree(tmp_path / "model.msgpack", variables)
    rng = np.random.default_rng(9)
    with open(tmp_path / "wav.scp", "w") as scp, open(tmp_path / "text", "w") as text:
        for i, (n, words) in enumerate([(4000, "abc"), (3100, "ba ca")]):
            write_wav(tmp_path / f"u{i}.wav", 16000, (rng.standard_normal(n) * 0.3))
            scp.write(f"u{i} {tmp_path / f'u{i}.wav'}\n")
            text.write(f"u{i} {words}\n")
    args = dict(wav_scp=str(tmp_path / "wav.scp"), text=str(tmp_path / "text"),
                asr_train_config=str(tmp_path / "config.yaml"),
                asr_model_file=str(tmp_path / "model.msgpack"))
    jalign.align(str(tmp_path / "j"), **args)
    got = asr_align.main([x for k, v in args.items() for x in (f"--{k}", v)]
                         + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    for name in ("segments", "aligned"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert sorted(got) == ["u0", "u1"] and len(got["u1"]) == 5
