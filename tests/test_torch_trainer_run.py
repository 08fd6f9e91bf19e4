"""Port vs JAX, the training runtime: Trainer.run of both packages on the
tiny ASRModel of tests/test_torch_train.py (intermediate CTC on block 1 at
weight 0.3, dropout 0, SpecAug off) from the same weights and batches,
adam with warmuplr, accum_grad 2 with a tail, 2 epochs; then the port's
own guarantees: resume equals an uninterrupted run bit for bit, the fused
path, the non-finite skip, early stopping, the plateau loop, checkpoint
pruning, averaging and load_partial, and the LLM left out of every file."""

import json
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_guided_asr_tpu.models.asr_model import ASRModel as JASRModel
from llm_guided_asr_tpu.models.asr_model import ASRModelConfig as JASRModelConfig
from llm_guided_asr_tpu.models.conformer import ConformerConfig as JConformerConfig
from llm_guided_asr_tpu.models.transformer_decoder import (
    TransformerDecoderConfig as JDecoderConfig,
)
from llm_guided_asr_tpu.ops.frontend import FrontendConfig as JFrontendConfig
from llm_guided_asr_tpu.train import optim as joptim
from llm_guided_asr_tpu.train import trainer as jtrainer
from llm_guided_asr_tpu_torch.convert import params_from_jax
from llm_guided_asr_tpu_torch.models.asr_model import ASRModel, ASRModelConfig
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig
from llm_guided_asr_tpu_torch.train import checkpoint as tckpt
from llm_guided_asr_tpu_torch.train import optim as toptim
from llm_guided_asr_tpu_torch.train import trainer as ttrainer
from llm_guided_asr_tpu_torch.train.reporter import Reporter
from test_torch_train import ASR, OPT, VOCAB, _batch, _np, _torch_batch, jit
from test_torch_transducer import seeded_variables

torch.set_num_threads(1)

# two blocks, so that block 1 is a tap in the middle of the encoder and the
# interCTC gradient stops short of block 2
INTER = dict(interctc_layer_idx=(1,), num_blocks=2)
SCHED = dict(scheduler="warmuplr", scheduler_conf={"warmup_steps": 4})
TIME_KEYS = {"time", "iter_time", "grad_time", "optim_step_time", "train_step_time"}
N_TRAIN, N_VALID = 5, 2  # 5 microbatches at accum_grad 2: 2 updates and a tail of 1


def _batches(seed, n):
    return [_batch(np.random.default_rng(seed + i)) for i in range(n)]


def _order(epoch, n):
    return np.random.default_rng(epoch).permutation(n)


def _jax_factory(batches):
    return lambda epoch: [{k: jnp.asarray(v) for k, v in batches[i].items()}
                          for i in _order(epoch, len(batches))]


def _port_factory(batches):
    return lambda epoch: [_torch_batch(batches[i]) for i in _order(epoch, len(batches))]


def _configs(**encoder):
    enc = {**ASR["encoder"], **encoder}
    jcfg = JASRModelConfig(vocab_size=VOCAB, frontend=JFrontendConfig(**ASR["frontend"]),
                           normalize="utterance_mvn", encoder=JConformerConfig(**enc),
                           decoder=JDecoderConfig(**ASR["decoder"]), ctc_weight=0.3,
                           interctc_weight=0.3)
    tcfg = ASRModelConfig(vocab_size=VOCAB, frontend=FrontendConfig(**ASR["frontend"]),
                          normalize="utterance_mvn", encoder=ConformerConfig(**enc),
                          decoder=TransformerDecoderConfig(**ASR["decoder"]), ctc_weight=0.3,
                          interctc_weight=0.3)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_inter():
    jcfg, tcfg = _configs(**INTER)
    jmodel = JASRModel(jcfg)
    batch = _batch(np.random.default_rng(0))
    # seeded weights at init-like scales, no flax init to compile
    variables = seeded_variables(jmodel, *(jnp.asarray(batch[k])
                                           for k in jtrainer.DEFAULT_BATCH_ARGS))
    return jmodel, _np(variables), tcfg


def _port_model(tcfg, variables):
    model = ASRModel(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def _options(**kw):
    base = dict(max_epoch=2, accum_grad=2, log_interval=2, keep_nbest_models=2, seed=0)
    return {**base, **kw}


@pytest.fixture(scope="module")
def jax_run(jax_inter, tmp_path_factory):
    """The JAX Trainer.run, once for the module."""
    jmodel, variables, _ = jax_inter
    out = tmp_path_factory.mktemp("jax_run")
    tx = joptim.build_optimizer("adam", dict(OPT), **SCHED)
    state = jtrainer.Trainer.run(
        jmodel, jax.tree_util.tree_map(jnp.asarray, variables), tx,
        _jax_factory(_batches(100, N_TRAIN)), _jax_factory(_batches(200, N_VALID)), out,
        jtrainer.TrainerOptions(**_options()))
    return state, out


def _stats(out: Path):
    stats = json.loads((out / "reporter.json").read_text())["stats"]
    return {e: {ph: {k: v for k, v in s.items() if k not in TIME_KEYS} for ph, s in p.items()}
            for e, p in stats.items()}


def test_interctc_loss_and_gradients_match_jax(jax_inter):
    """loss, loss_ctc, loss_interctc, loss_att, acc (rtol 1e-4) and every
    gradient (rtol 1e-3, atol 1e-5, as tests/test_torch_train.py)."""
    jmodel, variables, tcfg = jax_inter
    batch = _batch(np.random.default_rng(7))
    jargs = [jnp.asarray(batch[k]) for k in jtrainer.DEFAULT_BATCH_ARGS]

    def j_loss(params):
        (loss, stats, _), _ = jmodel.apply({**variables, "params": params}, *jargs,
                                           deterministic=False, mutable=["batch_stats"])
        return loss, stats

    (_, j_stats), j_grads = jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables["params"])
    model = _port_model(tcfg, variables).train()
    loss, stats, _ = model(*_torch_batch(batch).values())
    loss.backward()
    assert stats.keys() == j_stats.keys() and "loss_interctc" in stats
    for k in stats:
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    want = params_from_jax({"params": _np(j_grads)})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=name)
    taps = model.eval().encode_with_intermediates(*list(_torch_batch(batch).values())[:2])[2]
    assert len(taps) == 1 and taps[0].shape[-1] == tcfg.encoder.output_size


def test_trainer_run_matches_jax(jax_inter, jax_run, tmp_path):
    """2 epochs of 5 microbatches at accum_grad 2 (3 updates an epoch, the
    tail included): every train and valid stat of reporter.json (rtol
    2e-4: six updates of float32 drift), the update count, the final
    weights (atol 2e-5) and the averaged checkpoint against JAX's msgpack."""
    _, variables, tcfg = jax_inter
    j_state, j_out = jax_run
    model = _port_model(tcfg, variables)
    state = ttrainer.Trainer.run(
        model, toptim.build_optimizer("adam", dict(OPT), **SCHED),
        _port_factory(_batches(100, N_TRAIN)), _port_factory(_batches(200, N_VALID)), tmp_path,
        ttrainer.TrainerOptions(**_options()))
    assert state.step == int(j_state["step"]) == 6
    got, want = _stats(tmp_path), _stats(j_out)
    assert got.keys() == want.keys() == {"1", "2"}
    for e in got:
        assert got[e].keys() == want[e].keys() == {"train", "valid"}
        for ph in got[e]:
            assert got[e][ph].keys() == want[e][ph].keys(), (e, ph)
            assert "loss_interctc" in got[e][ph]
            for k, v in got[e][ph].items():
                np.testing.assert_allclose(v, want[e][ph][k], rtol=2e-4, err_msg=f"{e} {ph} {k}")
    final = params_from_jax(_np({"params": j_state["params"], **j_state["extra"]}))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), final[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)
    ave = tckpt.load(tmp_path / "valid.loss.ave_2best.pth")
    j_ave = params_from_jax(flax.serialization.msgpack_restore(
        (j_out / "valid.loss.ave_2best.msgpack").read_bytes()))
    assert ave.keys() == j_ave.keys()
    for name in ave:
        np.testing.assert_allclose(ave[name].numpy(), j_ave[name].numpy(), rtol=0, atol=2e-5,
                                   err_msg=name)
    assert sorted(p.name for p in tmp_path.glob("*epoch.pth")) == ["1epoch.pth", "2epoch.pth"]
    assert (tmp_path / "checkpoint.pth").is_file()
    assert (tmp_path / "latest.pth").resolve().name == "2epoch.pth"


def _noisy_config():
    """The tiny model with dropout 0.1 and SpecAug: the generator matters."""
    enc = {**ASR["encoder"], "dropout_rate": 0.1, "attention_dropout_rate": 0.1}
    return ASRModelConfig(vocab_size=VOCAB, frontend=FrontendConfig(**ASR["frontend"]),
                          normalize="utterance_mvn", specaug=SpecAugConfig(),
                          encoder=ConformerConfig(**enc),
                          decoder=TransformerDecoderConfig(**{**ASR["decoder"],
                                                              "dropout_rate": 0.1}),
                          ctc_weight=0.3)


def _fresh(cfg, seed=0):
    from llm_guided_asr_tpu_torch.convert import init_weights

    return init_weights(ASRModel(cfg, device="cpu"), seed=seed)


def test_resume_equals_an_uninterrupted_run_bit_for_bit(tmp_path):
    cfg = _noisy_config()
    train, valid = _port_factory(_batches(300, 3)), _port_factory(_batches(400, 1))
    tx = lambda: toptim.build_optimizer("adam", dict(OPT), **SCHED)  # noqa: E731
    a = _fresh(cfg)
    ttrainer.Trainer.run(a, tx(), train, valid, tmp_path / "a",
                         ttrainer.TrainerOptions(**_options(max_epoch=2)))
    a = _fresh(cfg)  # a new process: fresh weights, then the checkpoint
    sa = ttrainer.Trainer.run(a, tx(), train, valid, tmp_path / "a",
                              ttrainer.TrainerOptions(**_options(max_epoch=3, resume=True)))
    b = _fresh(cfg)
    sb = ttrainer.Trainer.run(b, tx(), train, valid, tmp_path / "b",
                              ttrainer.TrainerOptions(**_options(max_epoch=3)))
    assert sa.step == sb.step == 6
    assert _stats(tmp_path / "a") == _stats(tmp_path / "b")
    for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), n
    reporter = Reporter.load(tmp_path / "a" / "reporter.json")
    assert sorted(reporter.stats) == [1, 2, 3]


def test_fused_path_at_accum_grad_one(tmp_path):
    """accum_grad 1: Trainer.run's epoch equals fused steps by hand over the
    same batches with the epoch's generator; train_step_time is probed."""
    cfg = _noisy_config()
    batches = _batches(500, 3)
    model = _fresh(cfg)
    state = ttrainer.Trainer.run(model, toptim.build_optimizer("adam", dict(OPT)),
                                 _port_factory(batches), _port_factory(batches[:1]), tmp_path,
                                 ttrainer.TrainerOptions(**_options(max_epoch=1, accum_grad=1)))
    ref = _fresh(cfg)
    ref_state = ttrainer.init_train_state(ref, toptim.build_optimizer("adam", dict(OPT)))
    step = ttrainer.make_fused_train_step(
        ref, ref_state, torch.Generator().manual_seed(ttrainer.epoch_seed(0, 1)))
    for b in _port_factory(batches)(1):
        step(b)
    assert state.step == ref_state.step == 3
    assert all(torch.equal(x, y) for x, y in zip(model.state_dict().values(),
                                                 ref.state_dict().values()))
    train = json.loads((tmp_path / "reporter.json").read_text())["stats"]["1"]["train"]
    assert train["train_step_time"] > 0 and "grad_time" not in train


class Toy(torch.nn.Module):
    """loss = 1 (NaN at a NaN scale) whose gradient is ``scale`` everywhere."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))
        self.scale = 1.0

    def forward(self, speech, speech_lengths, text, text_lengths, rng=None):
        loss = self.scale * (self.w - self.w.detach()).sum() + 1.0
        return loss, {"loss": loss.detach()}, torch.tensor(1.0)


TOY_BATCH = dict.fromkeys(ttrainer.BATCH_ARGS, torch.zeros(1, 1))


def test_non_finite_microbatch_skips_the_accumulated_update(tmp_path):
    model = Toy()
    scales = iter([1.0, float("nan"), 1.0, 1.0])

    class Batches:
        def __iter__(self):
            for _ in range(4):
                model.scale = next(scales)
                yield TOY_BATCH

    state = ttrainer.Trainer.run(model, toptim.build_optimizer("sgd", {"lr": 0.1}),
                                 lambda e: Batches(), lambda e: [TOY_BATCH], tmp_path,
                                 ttrainer.TrainerOptions(max_epoch=1, accum_grad=2,
                                                         log_interval=1))
    assert state.step == 1  # microbatches 1-2 skipped, 3-4 applied
    np.testing.assert_allclose(model.w.detach().numpy(), 1.0 - 0.1 * (0.5 + 0.5))


def test_patience_stops_early(tmp_path):
    model = Toy()
    ttrainer.Trainer.run(model, toptim.build_optimizer("sgd", {"lr": 0.0}),
                         lambda e: [TOY_BATCH], lambda e: [TOY_BATCH], tmp_path,
                         ttrainer.TrainerOptions(max_epoch=10, patience=1, log_interval=1))
    assert sorted(Reporter.load(tmp_path / "reporter.json").stats) == [1, 2, 3]


def test_plateau_loop_ends_at_a_hundredth(tmp_path):
    """tests/test_trainer_guards.py::test_plateau_in_trainer_loop: a flat
    validation loss, factor 0.1, patience 0: epochs 2 and 3 each cut the
    scale; the checkpoint carries it, and a resume replays it."""
    model = Toy()
    tx = toptim.build_optimizer("adam", {"lr": 0.1}, scheduler="reducelronplateau",
                                scheduler_conf={"factor": 0.1, "patience": 0})
    opts = dict(log_interval=1, plateau_conf={"factor": 0.1, "patience": 0})
    state = ttrainer.Trainer.run(model, tx, lambda e: [TOY_BATCH], lambda e: [TOY_BATCH],
                                 tmp_path, ttrainer.TrainerOptions(max_epoch=3, **opts))
    np.testing.assert_allclose(state.plateau_scale, 0.01, rtol=1e-6)
    np.testing.assert_allclose(tckpt.load(tmp_path / "checkpoint.pth")["plateau_scale"], 0.01)
    again = ttrainer.Trainer.run(Toy(), tx, lambda e: [TOY_BATCH], lambda e: [TOY_BATCH],
                                 tmp_path, ttrainer.TrainerOptions(max_epoch=3, resume=True,
                                                                   **opts))
    np.testing.assert_allclose(again.plateau_scale, 0.01, rtol=1e-6)
    with pytest.raises(ValueError, match="plateau"):
        ttrainer.Trainer.run(Toy(), toptim.build_optimizer("adam"), lambda e: [],
                             lambda e: [], tmp_path / "x",
                             ttrainer.TrainerOptions(max_epoch=1, **opts))


def test_mesh_options_raise():
    for kw in ({"data_parallel": 0}, {"model_parallel": 2}, {"sharded_optim": True}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            ttrainer.TrainerOptions(**kw)
    ttrainer.TrainerOptions(rng_impl="threefry", flat_optim=True)


class WithInts(torch.nn.Module):
    def __init__(self, v):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((3,), float(v)))
        self.register_buffer("ids", torch.full((2,), v, dtype=torch.int64))


def test_pruning_links_and_averaging(tmp_path):
    """Two criteria keep the union of their best two and the latest; the
    average is the float64 mean of the best epochs' floats, stored in their
    dtype, and the integer buffer comes from the newest averaged epoch."""
    ckpt = tckpt.CheckpointManager(tmp_path, keep_nbest=2,
                                   best_criteria=[("valid", "acc", "max"),
                                                  ("valid", "loss", "min")])
    reporter = Reporter()
    acc = [0.1, 0.5, 0.3, 0.4, 0.2]
    loss = [5.0, 1.0, 4.0, 3.0, 0.5]
    opt = torch.optim.SGD(WithInts(0).parameters(), lr=0.1)
    for e in range(1, 6):
        reporter.set_epoch(e)
        sub = reporter.start_phase("valid")
        sub.register({"acc": acc[e - 1], "loss": loss[e - 1]})
        reporter.finish_phase(sub)
        ckpt.save_epoch(e, WithInts(e), opt, e, 1.0, reporter)
    assert sorted(p.name for p in tmp_path.glob("*epoch.pth")) == \
        ["2epoch.pth", "4epoch.pth", "5epoch.pth"]
    assert (tmp_path / "valid.acc.best.pth").resolve().name == "2epoch.pth"
    assert (tmp_path / "valid.loss.best.pth").resolve().name == "5epoch.pth"
    out = ckpt.average_nbest(reporter, "valid", "acc", "max")
    assert out.name == "valid.acc.ave_2best.pth"
    ave = tckpt.load(out)
    assert ave["w"].dtype == torch.float32 and torch.equal(ave["w"], torch.full((3,), 3.0))
    assert torch.equal(ave["ids"], torch.full((2,), 4, dtype=torch.int64))


def test_load_partial_and_the_jax_prefix_spelling(tmp_path):
    cfg = _noisy_config()
    src, dst = _fresh(cfg, seed=1), _fresh(cfg, seed=2)
    tckpt.save(tmp_path / "1epoch.pth", tckpt.host_state_dict(src.state_dict(),
                                                                ["params/decoder"]))
    missing = tckpt.load_partial(dst, tmp_path / "1epoch.pth", "encoder", "params/encoder")
    sd, ref = dst.state_dict(), src.state_dict()
    assert all(torch.equal(sd[k], ref[k]) for k in sd if k.startswith("encoder."))
    assert any(k.startswith("decoder.") for k in missing)
    assert not torch.equal(sd["ctc_head.weight"], ref["ctc_head.weight"])
    with pytest.raises(KeyError):
        tckpt.load_partial(dst, tmp_path / "1epoch.pth", "", "nowhere")
    assert tckpt.state_prefixes(["params/llm", "decoder/llm", "ctc_head"]) == \
        ("llm", "decoder.llm", "ctc_head")


def test_guided_model_leaves_the_llm_out_of_every_file(tmp_path):
    """Phase 2 on the tiny guided model of tests/test_torch_train_guided.py:
    encoder, ctc_head and llm frozen, one epoch with exclude_prefixes
    ('params/llm',): no file holds an llm key, the frozen weights stay, and
    load_partial restores every other tensor into a fresh model."""
    from llm_guided_asr_tpu_torch.convert import init_weights
    from llm_guided_asr_tpu_torch.models import llm_guided as tlg
    from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
    from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
    from test_torch_train_guided import FROZEN, GUIDED, LLM, PROMPT

    cfg = tlg.LLMGuidedASRConfig(
        vocab_size=50, llm=LlamaConfig(**LLM), prompt=PromptTemplate(**PROMPT),
        frontend=FrontendConfig(**GUIDED["frontend"]), normalize="utterance_mvn",
        encoder=ConformerConfig(**GUIDED["encoder"]),
        decoder=TransformerDecoderConfig(**GUIDED["decoder"]), ctc_weight=0.3)

    def build(seed):
        return init_weights(tlg.LLMGuidedASRModel(cfg, llm_dtype=torch.float32, device="cpu"),
                            seed=seed)

    model = build(0)
    frozen = toptim.path_prefix_mask(model, FROZEN)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [_batch(np.random.default_rng(20 + i), b=2, s=9000, l=4, lo=8, hi=50)
               for i in range(2)]
    ttrainer.Trainer.run(model, toptim.build_optimizer("adam", dict(OPT), freeze_mask=frozen),
                         _port_factory(batches), _port_factory(batches[:1]), tmp_path,
                         ttrainer.TrainerOptions(max_epoch=1, log_interval=1,
                                                 exclude_prefixes=("params/llm",)))
    after = model.state_dict()
    assert all(torch.equal(after[n], before[n]) for n in frozen)
    for path in tmp_path.glob("*.pth"):
        obj = tckpt.load(path)
        keys = obj["model"] if "model" in obj else obj
        assert keys and not any(k == "llm" or k.startswith("llm.") for k in keys), path.name
    fresh = build(1)
    missing = tckpt.load_partial(fresh, tmp_path / "1epoch.pth")
    assert missing and all(k.startswith("llm.") for k in missing)
    restored = fresh.state_dict()
    assert all(torch.equal(restored[k], after[k]) for k in after if not k.startswith("llm."))
