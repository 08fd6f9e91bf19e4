"""Port vs JAX, one fused train step of the RWKV transducer from the same
weights (the model of tests/test_torch_transducer.py), as the JAX trainer
takes it."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import transducer as ttd
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer
from test_torch_train import OPT, _assert_state_close, _np
from test_torch_transducer import _batch, _configs, _models, _torch_batch

torch.set_num_threads(1)


def test_fused_train_step_matches_jax():
    """One AdamW step of the RWKV transducer (clip 5): the loss at 1e-4,
    every parameter afterwards at 1e-5."""
    jmodel, variables, _ = _models("rwkv")
    tcfg = _configs("rwkv")[1]
    batch = _batch(4)
    tx = joptim.build_optimizer("adamw", dict(OPT))
    state = jtrainer.init_train_state(variables, tx)
    j_step = jtrainer.make_fused_train_step(jmodel, tx)
    params, _, extra, jstats, _ = j_step(state["params"], state["opt_state"], state["extra"],
                                         {k: jnp.asarray(v) for k, v in batch.items()},
                                         jax.random.PRNGKey(0))
    tmodel = ttd.TransducerModel(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    tstate = ttrainer.init_train_state(tmodel, toptim.build_optimizer("adamw", dict(OPT)))
    step = ttrainer.make_fused_train_step(tmodel, tstate, torch.Generator().manual_seed(0))
    stats, _ = step(_torch_batch(batch))
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=1e-4)
    assert tstate.step == 1
    _assert_state_close(tmodel, {"params": params, **extra}, atol=1e-5)
