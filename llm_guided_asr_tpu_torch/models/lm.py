"""Language models for shallow fusion (counterpart of llm_guided_asr_tpu/models/lm.py).

- :class:`TransformerLM` (espnet2/lm/transformer_lm.py): embed -> Linear ->
  LayerNorm -> ReLU -> sinusoidal positions -> N causal pre-norm encoder
  layers -> LayerNorm -> vocabulary;
- :class:`SequentialRNNLM` (espnet2/lm/seq_rnn_lm.py): embed -> stacked
  LSTM or GRU -> vocabulary, the cells laid out as flax's
  ``OptimizedLSTMCell`` and ``GRUCell`` (one Linear per gate, named as the
  flax Dense modules) and run over every position, pads included, from a
  zero state, as flax's ``nn.RNN`` without ``seq_lengths`` does;
- :class:`ESPnetLanguageModel` (espnet2/lm/espnet_model.py): the summed
  token NLL of <sos> y <eos> (sos = eos = V - 1, pad 0);
- :func:`make_lm_score_fn`: an LM as the beam search's full scorer,
  (tokens [N, L], lengths [N]) -> log-probs [N, V] of the next token; it
  runs the whole prefix at every step, as the JAX scorer does (no cache);
- :func:`lm_rescore_nbest`: n-best rescoring with the LM's log-probability.

The bare flax LayerNorms of the Transformer LM (``input_norm``,
``after_norm``) take flax's epsilon 1e-6; its encoder layers take 1e-5.

Compute dtype (JAX's ``dtype``, passed from code; the LM task, the LM
CLIs and the recognizer's fused LM build float32, as JAX's do): the
embedding rows are cast to it (flax's ``nn.Embed`` with ``dtype``).  The
Transformer LM computes every layer in it; the RNN LM's cells take no
dtype in JAX (models/lm.py:116-118), so flax promotes their input to the
float32 parameters: the LSTM runs on the kernel's float32 entry and the GRU
its float32 cell, and the output Dense casts the states back.  Both return
the logits in float32, unrounded (models/transformer.py Dense ``f32_out``):
every caller takes a float32 log-softmax of them at once (:151, :171).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    PositionalEncoding,
    TransformerEncoderLayer,
    at_least_f32,
    register_compute_dtype,
    to_compute,
)
from llm_guided_asr_tpu_torch.ops.lstm import lstm_recurrence
from llm_guided_asr_tpu_torch.utils.config import filter_known_fields
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import causal_attn_mask, make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    vocab_size: int = 1000
    pos_enc: Optional[str] = "sinusoidal"
    embed_unit: int = 128
    att_unit: int = 256
    head: int = 2
    unit: int = 1024
    layer: int = 4
    dropout_rate: float = 0.5

    @classmethod
    def from_dict(cls, d: dict, vocab_size: int) -> "TransformerLMConfig":
        d = filter_known_fields(cls, d, "lm_conf")
        d.pop("vocab_size", None)
        return cls(vocab_size=vocab_size, **d)


class TransformerLM(nn.Module):
    """(tokens [B, L], lengths [B]) -> float32 logits [B, L, V] under a
    causal mask, computed in ``dtype``."""

    def __init__(self, cfg: TransformerLMConfig, device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.pos_enc != "sinusoidal":
            # the reference adds no positional encoding for None, the JAX
            # package adds the sinusoidal one whatever the value: the port
            # computes neither silently
            raise ValueError(f"pos_enc={cfg.pos_enc!r}: only 'sinusoidal' is supported (for "
                             f"None the JAX package still adds the sinusoidal encoding, "
                             f"the reference adds none)")
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            register_compute_dtype(self, dtype)
            self.embed = nn.Embedding(cfg.vocab_size, cfg.embed_unit)
            self.input_proj = Dense(cfg.embed_unit, cfg.att_unit)
            self.input_norm = LayerNorm(cfg.att_unit, eps=1e-6)
            self.pos_enc = PositionalEncoding(cfg.dropout_rate)
            for i in range(cfg.layer):
                setattr(self, f"block_{i}", TransformerEncoderLayer(
                    cfg.att_unit, cfg.head, cfg.unit, cfg.dropout_rate, 0.0))
            self.after_norm = LayerNorm(cfg.att_unit, eps=1e-6)
            self.output = Dense(cfg.att_unit, cfg.vocab_size)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        cfg = self.cfg
        x = self.input_norm(self.input_proj(to_compute(self, self.embed(tokens))))
        x = torch.relu(dropout(x, active_rate(self, cfg.dropout_rate), rng))
        x = self.pos_enc(x, rng=rng)
        mask = causal_attn_mask(lengths, tokens.shape[1])
        for i in range(cfg.layer):
            x = getattr(self, f"block_{i}")(x, mask, rng)
        return self.output(self.after_norm(x), f32_out=True)


@dataclasses.dataclass(frozen=True)
class SequentialRNNLMConfig:
    vocab_size: int = 1000
    unit: int = 650
    nlayers: int = 2
    rnn_type: str = "lstm"  # lstm | gru

    @classmethod
    def from_dict(cls, d: dict, vocab_size: int) -> "SequentialRNNLMConfig":
        d = filter_known_fields(cls, d, "lm_conf")
        d.pop("vocab_size", None)
        return cls(vocab_size=vocab_size, **d)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: gates i, f, g, o; input Linears ``ii``
    ``if`` ``ig`` ``io`` (``in_features`` -> ``features``) without bias,
    hidden ones ``hi`` ``hf`` ``hg`` ``ho`` with it; c' = f c + i g,
    h' = o tanh(c')."""

    gates = ("i", "f", "g", "o")

    def __init__(self, features: int, in_features: Optional[int] = None):
        super().__init__()
        for g in self.gates:
            self.add_module(f"i{g}", nn.Linear(in_features or features, features, bias=False))
            self.add_module(f"h{g}", nn.Linear(features, features))

    def stacked(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(W_ih [4H, in], W_hh [4H, H], bias [4H]): the per-gate matrices
        stacked in the gate order i, f, g, o; the trainable tensors stay
        the per-gate Linears."""
        w_i = torch.cat([getattr(self, f"i{g}").weight for g in self.gates])
        w_h = torch.cat([getattr(self, f"h{g}").weight for g in self.gates])
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in self.gates])
        return w_i, w_h, b_h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, in] -> [B, L, H] over every position from a zero state."""
        return lstm_stack([self], x)


def lstm_stack(cells: List[LSTMCell], x: torch.Tensor) -> torch.Tensor:
    """Stacked LSTM cells over [B, L, in] from a zero state -> the last
    layer's outputs [B, L, H]: per layer, one GEMM of the input projections
    and one fused recurrence over the whole sequence (ops/lstm.py: one
    kernel launch on the card)."""
    for cell in cells:
        w_i, w_h, b_h = cell.stacked()
        x = lstm_recurrence(x @ w_i.t(), w_h, b_h)
    return x


class GRUCell(nn.Module):
    """flax ``GRUCell``: r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) +
    hz(h)), n = tanh(in(x) + r * hn(h)), h' = (1 - z) n + z h; the input
    Linears and ``hn`` carry the biases."""

    def __init__(self, features: int):
        super().__init__()
        for g in ("r", "z", "n"):
            self.add_module(f"i{g}", nn.Linear(features, features))
            self.add_module(f"h{g}", nn.Linear(features, features, bias=(g == "n")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        get = lambda name: getattr(self, name)  # noqa: E731
        xr, xz, xn = get("ir")(x), get("iz")(x), get("in")(x)
        h = x.new_zeros(x.shape[0], x.shape[2])
        out = []
        for t in range(x.shape[1]):
            r = torch.sigmoid(xr[:, t] + get("hr")(h))
            z = torch.sigmoid(xz[:, t] + get("hz")(h))
            n = torch.tanh(xn[:, t] + r * get("hn")(h))
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


class SequentialRNNLM(nn.Module):
    """(tokens [B, L], lengths [B]) -> float32 logits [B, L, V]; the
    recurrence runs over all L positions (``lengths`` is not read, as in
    JAX), in float32 whatever ``dtype`` (the embedding's and the output
    Dense's) is."""

    def __init__(self, cfg: SequentialRNNLMConfig, device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cells = {"lstm": LSTMCell, "gru": GRUCell}
        if cfg.rnn_type not in cells:
            raise ValueError(f"rnn_type={cfg.rnn_type!r}; expected lstm or gru")
        self.cfg = cfg
        with torch.device(resolve_device(device)):
            register_compute_dtype(self, dtype)
            self.embed = nn.Embedding(cfg.vocab_size, cfg.unit)
            for i in range(cfg.nlayers):
                setattr(self, f"rnn_{i}", cells[cfg.rnn_type](cfg.unit))
            self.output = Dense(cfg.unit, cfg.vocab_size)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        # the cells' float32, as flax promotes the compute-dtype rows
        x = at_least_f32(to_compute(self, self.embed(tokens)))
        for i in range(self.cfg.nlayers):
            x = getattr(self, f"rnn_{i}")(x)
        return self.output(x, self.compute.dtype, f32_out=True)


class ESPnetLanguageModel(nn.Module):
    """The LM task's model: ``nll`` per example and the mean-NLL loss."""

    def __init__(self, lm: nn.Module, vocab_size: int, ignore_id: int = 0):
        super().__init__()
        self.lm = lm
        self.vocab_size = vocab_size
        self.ignore_id = ignore_id

    @property
    def compute(self) -> torch.Tensor:
        """The LM's compute-dtype buffer (models/transformer.py
        register_compute_dtype)."""
        return self.lm.compute

    def nll(self, text: torch.Tensor, text_lengths: torch.Tensor,
            rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """text [B, L] (pads anything) -> (summed token NLL [B], token counts
        [B]) of <sos> y <eos> (lm/espnet_model.py:37)."""
        b, l = text.shape
        sos = eos = self.vocab_size - 1
        valid = make_valid_mask(text_lengths, l)
        clean = torch.where(valid, text, torch.zeros_like(text))
        x = torch.cat([torch.full((b, 1), sos, dtype=text.dtype, device=text.device), clean], 1)
        pos = torch.arange(l + 1, device=text.device)[None, :]
        t = torch.cat([clean, torch.zeros((b, 1), dtype=text.dtype, device=text.device)], 1)
        t = torch.where(pos == text_lengths[:, None], torch.full_like(t, eos), t)
        t_valid = pos <= text_lengths[:, None]
        logp = F.log_softmax(self.lm(x, text_lengths + 1, rng).float(), dim=-1)
        tok_nll = -torch.gather(logp, 2, torch.clamp(t, min=0)[..., None].long())[..., 0]
        tok_nll = torch.where(t_valid, tok_nll, torch.zeros_like(tok_nll))
        return tok_nll.sum(dim=1), t_valid.sum(dim=1)

    def forward(self, text: torch.Tensor, text_lengths: torch.Tensor,
                rng: Optional[StepRNG] = None):
        """-> (loss, stats, weight): the mean NLL over all tokens."""
        nll, counts = self.nll(text, text_lengths, rng)
        loss = nll.sum() / torch.clamp(counts.sum(), min=1)
        stats = {"loss": loss, "perplexity": torch.exp(loss)}
        return loss, stats, torch.tensor(float(text.shape[0]), device=text.device)


def make_lm_score_fn(lm: nn.Module) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """An LM (``TransformerLM`` or ``SequentialRNNLM``) as a beam-search full
    scorer: (tokens [N, L], lengths [N]) -> float32 log-probs [N, V] of the
    token after each row's prefix (position lengths - 1)."""
    lm = lm.eval()

    def score(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        logits = lm(tokens, lengths)
        last = logits[torch.arange(tokens.shape[0], device=tokens.device), lengths - 1]
        return F.log_softmax(last.float(), dim=-1)

    return score


@torch.no_grad()
def lm_rescore_nbest(hyps: List, lm_model: ESPnetLanguageModel, weight: float = 0.5,
                     sos: int = 0, eos: int = 0) -> List:
    """n-best rescoring (espnet2/fst/lm_rescore.py, without the lattice):
    each hypothesis's score + weight * the LM log-probability of its tokens
    (sos and eos stripped: the LM wraps its own), the LM term kept as
    ``scores["lm_rescore"]``; returns them sorted by the new score."""
    dev = next(lm_model.parameters()).device
    rescored = []
    for h in hyps:
        ids = [i for i in h.yseq if i not in (sos, eos)]
        nll, _ = lm_model.nll(torch.tensor([ids or [0]], device=dev),
                              torch.tensor([max(len(ids), 1)], device=dev))
        lm_lp = -float(nll.sum())
        rescored.append(h._replace(score=h.score + weight * lm_lp,
                                   scores={**h.scores, "lm_rescore": lm_lp}))
    return sorted(rescored, key=lambda h: -h.score)
