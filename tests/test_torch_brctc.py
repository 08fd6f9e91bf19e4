"""Port vs JAX, the Bayes-risk CTC (``ctc_type: brctc``): the per-example
loss and the logits' gradient against JAX's ``ctc_loss_per_example`` and
``jax.grad`` at ``time_risk`` 0, 0.1 and 1.0 (ragged logit and label
lengths, a repeated label, one infeasible example: loss 0, gradient 0);
the Bayes-risk function at risk 0 equal to the builtin path; and an
``ASRModel`` with ``ctc_type: brctc`` and intermediate CTC, whose risk
reaches only the final CTC, against JAX's loss, stats and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.ops.losses import ctc_loss_per_example as j_ctc_loss_per_example
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.losses import BayesRiskCTC, ctc_loss_per_example
from test_torch_train import ASR, VOCAB, _batch, _np, _torch_batch, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)


def _case():
    """[4, 30, 9] logits; example 3 has 3 frames for the labels (2, 2, 3),
    which need 4: infeasible."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 30, 9)) * 2.0).astype(np.float32)
    logit_lengths = np.array([30, 25, 17, 3], np.int32)
    labels = rng.integers(1, 9, (4, 7)).astype(np.int32)
    labels[0, 2] = labels[0, 1]  # a repeat: the lattice's skip is barred there
    labels[3, :3] = (2, 2, 3)
    label_lengths = np.array([7, 4, 5, 3], np.int32)
    weights = np.array([1.0, -0.5, 2.0, 1.5], np.float32)  # d loss / d per-example
    return logits, logit_lengths, labels, label_lengths, weights


@pytest.mark.parametrize("time_risk", [0.0, 0.1, 1.0])
def test_brctc_loss_and_logits_gradient_match_jax(time_risk):
    logits, logit_lengths, labels, label_lengths, weights = _case()

    def j_loss(x):
        per_ex = j_ctc_loss_per_example(x, jnp.asarray(logit_lengths), jnp.asarray(labels),
                                        jnp.asarray(label_lengths), time_risk=time_risk)
        return jnp.sum(per_ex * weights), per_ex

    (_, j_per_ex), j_grad = jit(jax.value_and_grad(j_loss, has_aux=True))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    per_ex = ctc_loss_per_example(x, torch.from_numpy(logit_lengths).long(),
                                  torch.from_numpy(labels).long(),
                                  torch.from_numpy(label_lengths).long(), time_risk=time_risk)
    (per_ex * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(per_ex.detach().numpy(), np.asarray(j_per_ex), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-5)
    # the infeasible example: 0 and no gradient; no gradient past a length
    assert float(per_ex[3].detach()) == 0.0 and not x.grad[3].any()
    assert not x.grad[1, 25:].any() and not x.grad[2, 17:].any()
    if time_risk:
        plain = ctc_loss_per_example(torch.from_numpy(logits),
                                     *(torch.from_numpy(a).long() for a in _case()[1:4]))
        assert torch.all(per_ex[:3] > plain[:3])  # the delay risk only adds


def test_brctc_at_zero_risk_is_the_builtin_ctc():
    logits, logit_lengths, labels, label_lengths, weights = _case()
    args = (torch.from_numpy(logit_lengths).long(), torch.from_numpy(labels).long(),
            torch.from_numpy(label_lengths).long())
    xs = [torch.from_numpy(logits).requires_grad_(True) for _ in range(2)]
    brctc = BayesRiskCTC.apply(xs[0], *args, 0, 0.0)
    builtin = ctc_loss_per_example(xs[1], *args)
    for loss in (brctc, builtin):
        (loss * torch.from_numpy(weights)).sum().backward()
    assert torch.equal(brctc.detach(), builtin.detach())
    # the two take softmax minus the posterior by different roundings
    np.testing.assert_allclose(xs[0].grad.numpy(), xs[1].grad.numpy(), rtol=0, atol=1e-5)


def test_asr_model_brctc_with_interctc_matches_jax():
    """ctc_weight 1.0 (the CTC terms alone), risk 0.5 on the final CTC,
    interctc over block 1 at weight 0.3 with no risk: loss, loss_ctc,
    loss_interctc and every gradient against JAX's."""
    enc = dict(ASR["encoder"], interctc_layer_idx=(1,), num_blocks=2)  # block 1 of 2
    common = dict(vocab_size=VOCAB, normalize="utterance_mvn", ctc_weight=1.0,
                  ctc_type="brctc", brctc_risk_factor=0.5, interctc_weight=0.3)
    jmodel = JASRModel(JASRModelConfig(frontend=JFrontendConfig(**ASR["frontend"]),
                                       encoder=JConformerConfig(**enc), **common))
    batch = _batch(np.random.default_rng(0))
    jargs = [jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS]
    variables = seeded_variables(jmodel, *jargs, seed=1)

    def j_loss(params):
        (loss, stats, _), _ = jmodel.apply({**variables, "params": params}, *jargs,
                                           deterministic=False, mutable=["batch_stats"])
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    tcfg = ASRModelConfig(frontend=FrontendConfig(**ASR["frontend"]),
                          encoder=ConformerConfig(**enc), **common)
    tmodel = ASRModel(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    tmodel.train()
    loss, stats, _ = tmodel(*_torch_batch(batch).values())
    loss.backward()
    assert stats.keys() == j_stats.keys() and "loss_interctc" in stats
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
