"""Port vs JAX, the phase-2 train step: the LLM-guided model with encoder,
ctc_head and llm frozen, one fused step from the same weights with every
dropout at 0, as the JAX trainer takes it."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from llm_guided_asr_tpu.models import llm_guided as jlg
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
from llm_guided_asr_tpu.models.llm.prompt import PromptTemplate as JPromptTemplate
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JDecoderConfig,
)
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models import llm_guided as tlg
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer
from test_torch_train import (
    NO_DROP_DEC,
    NO_DROP_ENC,
    OPT,
    _assert_state_close,
    _batch,
    _np,
    _torch_batch,
)
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

LLM = dict(vocab_size=50, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0,
           rope_scaling_factor=32.0, rope_original_max_position=64)
PROMPT = dict(prefix_ids=(2, 3, 4), suffix_ids=(5, 6), start_of_response_id=7,
              end_of_response_id=7, pad_id=0)
GUIDED = dict(frontend=dict(n_fft=256, hop_length=128, n_mels=23),
              encoder=dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=1,
                           macaron_style=True, cnn_module_kernel=7, **NO_DROP_ENC),
              decoder=dict(attention_heads=2, linear_units=64, num_blocks=1, **NO_DROP_DEC))
FROZEN = ["encoder", "ctc_head", "llm"]


def test_phase2_guided_train_step_matches_jax():
    """One step with encoder, ctc_head and llm frozen: they stay bit for bit,
    the guided decoder and its embed move as in JAX."""
    jcfg = jlg.LLMGuidedASRConfig(
        vocab_size=50, llm=JLlamaConfig(**LLM), prompt=JPromptTemplate(**PROMPT),
        frontend=JFrontendConfig(**GUIDED["frontend"]), normalize="utterance_mvn",
        encoder=JConformerConfig(**GUIDED["encoder"]), decoder=JDecoderConfig(**GUIDED["decoder"]),
        ctc_weight=0.3)
    jmodel = jlg.LLMGuidedASRModel(jcfg)
    batch = _batch(np.random.default_rng(2), b=2, s=9000, l=4, lo=8, hi=50)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # seeded weights at init-like scales, no flax init to compile
    variables = seeded_variables(jmodel, *(jbatch[k] for k in jtrainer.DEFAULT_BATCH_ARGS))
    tx = joptim.build_optimizer(
        "adam", dict(OPT), freeze_mask=joptim.path_prefix_mask(variables["params"], FROZEN))
    state = jtrainer.init_train_state(variables, tx)
    params, _, extra, j_stats, _ = jtrainer.make_fused_train_step(jmodel, tx)(
        state["params"], state["opt_state"], state["extra"], jbatch, jax.random.PRNGKey(0))

    tcfg = tlg.LLMGuidedASRConfig(
        vocab_size=50, llm=LlamaConfig(**LLM), prompt=PromptTemplate(**PROMPT),
        frontend=FrontendConfig(**GUIDED["frontend"]), normalize="utterance_mvn",
        encoder=ConformerConfig(**GUIDED["encoder"]),
        decoder=TransformerDecoderConfig(**GUIDED["decoder"]), ctc_weight=0.3)
    tmodel = tlg.LLMGuidedASRModel(tcfg, llm_dtype=torch.float32, device="cpu")
    tmodel.load_state_dict(params_from_jax(_np(variables)), strict=True)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    frozen = toptim.path_prefix_mask(tmodel, FROZEN)
    tstate = ttrainer.init_train_state(
        tmodel, toptim.build_optimizer("adam", dict(OPT), freeze_mask=frozen))
    stats, _ = ttrainer.make_fused_train_step(tmodel, tstate, torch.Generator().manual_seed(0))(
        _torch_batch(batch))
    np.testing.assert_allclose(float(stats["loss"]), float(j_stats["loss"]), rtol=1e-4)
    after = tmodel.state_dict()
    assert frozen and all(torch.equal(after[n], before[n]) for n in frozen)
    assert all(torch.equal(after[n], before[n]) for n in after if "running_" in n)
    trainable = [n for n, p in tmodel.named_parameters() if n not in frozen]
    assert trainable and all(not torch.equal(after[n], before[n]) for n in trainable)
    _assert_state_close(tmodel, {"params": params, **extra}, atol=1e-5, names=trainable)
