"""Transducer ASR (counterpart of llm_guided_asr_tpu/models/transducer.py).

frontend (or features as they are, ``frontend=None``) -> SpecAug
(training) -> normalize -> Conformer -> joint network tanh(W_enc h_t +
W_dec g_u) -> vocab over the prediction network's outputs g (a stateless
embedding, an LSTM, RWKV in models/rwkv.py or MEGA in
models/mega_decoder.py); loss = RNN-T (ops/rnnt.py; the multi-blank loss
when ``multi_blank_durations`` is set) + aux_ctc_weight * CTC on the
encoder.  ``forward`` takes the same ``rng`` as ASRModel, so that
train/trainer.py's fused step drives it unchanged.

Compute dtype (JAX's ``dtype``: float32, or bfloat16 for ``train_dtype:
bfloat16`` / ``use_amp``), as models/asr_model.py has it: float32
parameters, the features cast at the encoder's input (JAX ``encode``), the
prediction network's embedding rows cast to the compute dtype (flax's
``nn.Embed`` with ``dtype``), every Dense in its input's type.  The LSTM
prediction network computes in float32 inside a bfloat16 model, as flax
promotes it (JAX models/transducer.py:104 builds ``OptimizedLSTMCell``
without a dtype), and the joint casts its rows back.  The joint's and the
CTC head's logits are float32 products of the rounded operands (every
caller casts them to float32 at once); the lattice log-softmax, the losses
and the searches' log-probs are float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.asr_model import (
    check_compute_dtype,
    embed_labels,
    extract_features,
    register_compute_dtype,
    to_compute,
)
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.models.lm import LSTMCell, lstm_stack
from llm_guided_asr_tpu_torch.models.mega_decoder import MEGADecoder
from llm_guided_asr_tpu_torch.models.rwkv import RWKVDecoder
from llm_guided_asr_tpu_torch.models.transformer import Dense, at_least_f32
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig, require_log_mel
from llm_guided_asr_tpu_torch.ops.losses import ctc_loss
from llm_guided_asr_tpu_torch.ops.rnnt import rnnt_loss, rnnt_loss_multi_blank
from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


@dataclasses.dataclass(frozen=True)
class TransducerDecoderConfig:
    """The fields of the JAX TransducerDecoderConfig that the prediction
    networks read (``context_size`` is read by neither package)."""

    decoder_type: str = "stateless"  # stateless | rnn | rwkv | mega
    embed_size: int = 256
    hidden_size: int = 256
    num_layers: int = 1
    dropout_rate: float = 0.0
    mega_qk_size: int = 64
    mega_v_size: int = 0  # 0 -> 2 * hidden_size
    mega_num_heads: int = 4
    mega_rel_pos_bias: str = "simple"  # simple | rotary
    mega_max_positions: int = 2048  # positional-bias span (raises past it)
    mega_ffn_size: int = 0  # 0 -> 2 * hidden_size
    mega_att_dropout_rate: Optional[float] = None  # None -> dropout_rate
    mega_ema_dropout_rate: Optional[float] = None


class StatelessDecoder(nn.Module):
    """asr_transducer/decoder/stateless_decoder.py: [B, U] -> [B, U+1, H],
    an embedding of the labels after the blank context 0, in the compute
    dtype."""

    def __init__(self, vocab_size: int, cfg: TransducerDecoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.cfg = cfg
        register_compute_dtype(self, dtype)
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        if cfg.embed_size != cfg.hidden_size:
            self.proj = Dense(cfg.embed_size, cfg.hidden_size)

    def forward(self, labels: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        x = embed_labels(self, labels)
        x = dropout(x, active_rate(self, self.cfg.dropout_rate), rng)
        if self.cfg.embed_size != self.cfg.hidden_size:
            x = self.proj(x)
        return x


class RNNDecoder(nn.Module):
    """asr_transducer/decoder/rnn_decoder.py: [B, U] -> [B, U+1, H], an
    embedding of the labels after the blank context 0, dropout, then
    ``num_layers`` LSTM cells laid out as flax's ``OptimizedLSTMCell_{i}``
    (the names flax gives the cells that ``nn.RNN`` wraps), run as one
    fused recurrence over the whole sequence (models/lm.py lstm_stack).
    The embedding is in the compute dtype; the cells compute in float32
    (at least) and return float32 in a bfloat16 model."""

    def __init__(self, vocab_size: int, cfg: TransducerDecoderConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.cfg = cfg
        register_compute_dtype(self, dtype)
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        for i in range(cfg.num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}", LSTMCell(
                cfg.hidden_size, cfg.embed_size if i == 0 else cfg.hidden_size))

    def forward(self, labels: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        x = embed_labels(self, labels)
        x = dropout(x, active_rate(self, self.cfg.dropout_rate), rng)
        cells = [getattr(self, f"OptimizedLSTMCell_{i}") for i in range(self.cfg.num_layers)]
        # flax promotes the bfloat16 embedding to the cells' float32 (JAX
        # models/transducer.py:104: OptimizedLSTMCell without a dtype)
        return lstm_stack(cells, at_least_f32(x))


DECODERS = {"stateless": StatelessDecoder, "rnn": RNNDecoder, "rwkv": RWKVDecoder,
            "mega": MEGADecoder}


class JointNetwork(nn.Module):
    """asr_transducer/joint_network.py: tanh(W_enc h + W_dec g) -> vocab
    in the encoder rows' type (g is cast to it in ``lin_dec``); the logits
    in float32 (at least), not rounded, as every caller (the losses, the
    searches' log-softmax) casts them to float32 at once
    (models/transformer.py Dense ``dtype``, ``f32_out``)."""

    def __init__(self, vocab_size: int, enc_size: int, dec_size: int, joint_size: int = 256):
        super().__init__()
        self.lin_enc = Dense(enc_size, joint_size)
        self.lin_dec = Dense(dec_size, joint_size)
        self.lin_out = Dense(joint_size, vocab_size)

    def forward(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """enc [..., De] and dec [..., Dd], broadcastable -> [..., V]."""
        # in bfloat16 the add and the tanh each round, as the JAX joint's
        # compiled CPU graph does (JAX models/transducer.py:118-121)
        h = self.lin_enc(enc)
        return self.lin_out(torch.tanh(h + self.lin_dec(dec, h.dtype)), f32_out=True)


@dataclasses.dataclass(frozen=True)
class TransducerModelConfig:
    """The fields of the JAX TransducerModelConfig that the port reads, plus
    ``input_size``: the feature width when ``frontend`` is None (the JAX
    model reads it off its input)."""

    vocab_size: int
    frontend: Optional[FrontendConfig] = FrontendConfig()
    specaug: Optional[SpecAugConfig] = None
    normalize: str = "global_mvn"
    encoder_type: str = "conformer"
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransducerDecoderConfig = TransducerDecoderConfig()
    joint_size: int = 256
    aux_ctc_weight: float = 0.0
    blank_id: int = 0
    # multi-blank transducer (Xu et al. 2023): "big blank" outputs that each
    # cover several frames; ids and durations align index-wise, the ids
    # default to the top of the vocabulary; sigma under-normalizes the logits
    multi_blank_durations: Tuple[int, ...] = ()
    multi_blank_ids: Tuple[int, ...] = ()
    multi_blank_sigma: float = 0.05
    input_size: Optional[int] = None

    @property
    def big_blank_ids(self) -> Tuple[int, ...]:
        """The big blanks' ids: ``multi_blank_ids`` or V-1, V-2, ..."""
        return self.multi_blank_ids or tuple(
            self.vocab_size - 1 - i for i in range(len(self.multi_blank_durations)))

    @property
    def n_feat(self) -> int:
        if self.frontend is not None:
            return self.frontend.n_mels
        if self.input_size is None:
            raise ValueError("a transducer without a frontend needs input_size")
        return self.input_size

    @property
    def sos_id(self) -> int:  # interface parity with ASRModelConfig
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1


class TransducerModel(nn.Module):
    """The transducer, computing in ``dtype`` (float32, or bfloat16: see the
    module docstring).  ``.train()`` turns on dropout, SpecAug and batch
    statistics; the forward then needs a StepRNG."""

    def __init__(self, cfg: TransducerModelConfig, device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dec_type = cfg.decoder.decoder_type
        if dec_type not in DECODERS:
            raise ValueError(f"decoder_type={dec_type!r}; expected one of {sorted(DECODERS)}")
        if len(cfg.big_blank_ids) != len(cfg.multi_blank_durations):
            raise ValueError(f"multi_blank_ids {cfg.multi_blank_ids} and multi_blank_durations "
                             f"{cfg.multi_blank_durations} differ in length")
        require_log_mel(cfg.frontend, "the transducer")
        check_compute_dtype(dtype)
        dev = resolve_device(device)
        self.cfg = cfg
        n_feat = cfg.n_feat
        with torch.device(dev):
            register_compute_dtype(self, dtype)
            self.encoder = make_encoder(cfg.encoder_type, cfg.encoder, n_feat, device=dev,
                                        dtype=dtype)
            d = self.encoder.output_size
            self.decoder = DECODERS[dec_type](cfg.vocab_size, cfg.decoder, dtype=dtype)
            self.joint = JointNetwork(cfg.vocab_size, d, cfg.decoder.hidden_size, cfg.joint_size)
            if cfg.aux_ctc_weight > 0:
                self.ctc_head = Dense(d, cfg.vocab_size)
            if cfg.normalize == "global_mvn":
                # one statistic per feature; the JAX model keeps a single
                # one (broadcast) when it has no frontend
                n_mvn = n_feat if cfg.frontend is not None else 1
                self.register_buffer("mvn_mean", torch.zeros(n_mvn))
                self.register_buffer("mvn_inv_std", torch.ones(n_mvn))

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S] waveform (or [B, T, input_size] features without a
        frontend) -> ([B, T', D] encoder output, [B] lengths)."""
        feats, feats_lengths = extract_features(self, speech, speech_lengths, rng)
        return self.encoder(to_compute(self, feats), feats_lengths, rng)

    def joint_full(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """[B, T, De] x [B, U+1, Dd] -> [B, T, U+1, V] lattice logits (the
        encoder rows cast to the compute dtype; the joint casts the
        prediction network's, float32 from the LSTM in a bfloat16 model,
        as the joint's flax Dense casts its input)."""
        return self.joint(to_compute(self, enc)[:, :, None, :],
                          dec[:, None, :, :])

    def joint_step(self, enc_vec: torch.Tensor, dec_vec: torch.Tensor) -> torch.Tensor:
        """[B, De] x [B, Dd] -> [B, V]: one lattice cell (decoding)."""
        return self.joint(to_compute(self, enc_vec), dec_vec)

    def decode_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """[B, U] labels -> [B, U+1, H] prediction-network outputs (decoding)."""
        return self.decoder(labels)

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor, text: torch.Tensor,
                text_lengths: torch.Tensor, rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """text [B, U] padded with -1 -> (loss, stats, weight)."""
        cfg = self.cfg
        enc, enc_lens = self.encode(speech, speech_lengths, rng)
        # the decoder and the RNN-T loss see 0 for pads; the CTC the raw text
        labels = torch.where(make_valid_mask(text_lengths, text.shape[1]), text, 0)
        dec = self.decoder(labels, rng)  # [B, U+1, H]
        logits = self.joint_full(enc, dec)
        if cfg.multi_blank_durations:
            loss_rnnt = rnnt_loss_multi_blank(
                logits, labels, enc_lens, text_lengths, cfg.blank_id,
                big_blank_ids=cfg.big_blank_ids, big_blank_durations=cfg.multi_blank_durations,
                sigma=cfg.multi_blank_sigma)
        else:
            loss_rnnt = rnnt_loss(logits, labels, enc_lens, text_lengths, cfg.blank_id)
        stats = {"loss_rnnt": loss_rnnt}
        loss = loss_rnnt
        if cfg.aux_ctc_weight > 0:
            loss_ctc = ctc_loss(self.ctc_head(enc, f32_out=True), enc_lens, text, text_lengths,
                                cfg.blank_id)
            stats["loss_ctc"] = loss_ctc
            loss = loss + cfg.aux_ctc_weight * loss_ctc
        stats["loss"] = loss
        return loss, stats, torch.tensor(float(speech.shape[0]), device=enc.device)


def transducer_greedy_decode(model: TransducerModel, enc: torch.Tensor, enc_lens: torch.Tensor,
                             max_symbols_per_step: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch greedy decode: (tokens [B, T], n_tokens [B]).

    Walks the lattice: at (t, u) take the argmax; blank (or the per-frame
    symbol cap) advances t, a label advances u.  The prediction network is
    recomputed over the whole label prefix at each step and read at
    position n (cached stepping is later work).  The loop ends when every
    t >= enc_lens (one host read per step)."""
    b, t_max, _ = enc.shape
    u_max = t_max  # at most one emission per frame on average
    blank = model.cfg.blank_id
    dev = enc.device
    t = torch.zeros(b, dtype=torch.long, device=dev)
    n = torch.zeros(b, dtype=torch.long, device=dev)
    sym = torch.zeros(b, dtype=torch.long, device=dev)
    tokens = torch.zeros((b, u_max), dtype=torch.long, device=dev)
    pos = torch.arange(u_max, device=dev)
    enc_lens = enc_lens.to(dev)
    while bool((t < enc_lens).any()):
        dec_out = model.decode_labels(tokens)  # [B, U+1, H]
        g = dec_out[torch.arange(b, device=dev), n]
        h = enc[torch.arange(b, device=dev), t.clamp(0, t_max - 1)]
        pred = model.joint_step(h, g).argmax(dim=-1)
        active = t < enc_lens
        emit = active & (pred != blank) & (n < u_max - 1) & (sym < max_symbols_per_step)
        tokens = torch.where(emit[:, None] & (pos[None, :] == n[:, None]), pred[:, None], tokens)
        n = torch.where(emit, n + 1, n)
        sym = torch.where(emit, sym + 1, 0)
        t = torch.where(active & ~emit, t + 1, t)
    return tokens, n
