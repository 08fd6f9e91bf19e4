"""Transducer ASR (counterpart of llm_guided_asr_tpu/models/transducer.py).

frontend -> SpecAug (training) -> normalize -> Conformer -> joint network
tanh(W_enc h_t + W_dec g_u) -> vocab over the prediction network's outputs
g (stateless embedding or RWKV, models/rwkv.py); loss = RNN-T
(ops/rnnt.py) + aux_ctc_weight * CTC on the encoder.  ``forward`` takes
the same ``rng`` as ASRModel, so that train/trainer.py's fused step drives
it unchanged.  The LSTM and MEGA prediction networks and the multi-blank
loss are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from llm_guided_asr_tpu_torch.models.asr_model import extract_features
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.models.rwkv import RWKVDecoder
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.losses import ctc_loss
from llm_guided_asr_tpu_torch.ops.rnnt import rnnt_loss
from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG, active_rate, dropout


@dataclasses.dataclass(frozen=True)
class TransducerDecoderConfig:
    """The fields of the JAX TransducerDecoderConfig that the ported
    prediction networks read."""

    decoder_type: str = "stateless"  # stateless | rwkv (rnn and mega are not ported yet)
    embed_size: int = 256
    hidden_size: int = 256
    num_layers: int = 1
    dropout_rate: float = 0.0


class StatelessDecoder(nn.Module):
    """asr_transducer/decoder/stateless_decoder.py: [B, U] -> [B, U+1, H],
    an embedding of the labels after the blank context 0."""

    def __init__(self, vocab_size: int, cfg: TransducerDecoderConfig):
        super().__init__()
        self.vocab_size = vocab_size
        self.cfg = cfg
        self.embed = nn.Embedding(vocab_size, cfg.embed_size)
        if cfg.embed_size != cfg.hidden_size:
            self.proj = nn.Linear(cfg.embed_size, cfg.hidden_size)

    def forward(self, labels: torch.Tensor, rng: Optional[StepRNG] = None) -> torch.Tensor:
        y = torch.cat([torch.zeros_like(labels[:, :1]), labels], dim=1)
        x = self.embed(y.clamp(0, self.vocab_size - 1))
        x = dropout(x, active_rate(self, self.cfg.dropout_rate), rng)
        if self.cfg.embed_size != self.cfg.hidden_size:
            x = self.proj(x)
        return x


class JointNetwork(nn.Module):
    """asr_transducer/joint_network.py: tanh(W_enc h + W_dec g) -> vocab."""

    def __init__(self, vocab_size: int, enc_size: int, dec_size: int, joint_size: int = 256):
        super().__init__()
        self.lin_enc = nn.Linear(enc_size, joint_size)
        self.lin_dec = nn.Linear(dec_size, joint_size)
        self.lin_out = nn.Linear(joint_size, vocab_size)

    def forward(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """enc [..., De] and dec [..., Dd], broadcastable -> [..., V]."""
        return self.lin_out(torch.tanh(self.lin_enc(enc) + self.lin_dec(dec)))


@dataclasses.dataclass(frozen=True)
class TransducerModelConfig:
    """The fields of the JAX TransducerModelConfig that the port reads (the
    multi-blank ones are not ported yet)."""

    vocab_size: int
    frontend: FrontendConfig = FrontendConfig()
    specaug: Optional[SpecAugConfig] = None
    normalize: str = "global_mvn"
    encoder_type: str = "conformer"
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransducerDecoderConfig = TransducerDecoderConfig()
    joint_size: int = 256
    aux_ctc_weight: float = 0.0
    blank_id: int = 0

    @property
    def sos_id(self) -> int:  # interface parity with ASRModelConfig
        return self.vocab_size - 1

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1


class TransducerModel(nn.Module):
    """The transducer, float32.  ``.train()`` turns on dropout, SpecAug and
    batch statistics; the forward then needs a StepRNG."""

    def __init__(self, cfg: TransducerModelConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dec_type = cfg.decoder.decoder_type
        if dec_type in ("rnn", "mega"):
            raise NotImplementedError(
                f"decoder_type={dec_type!r} is not ported yet (a later slice of the port)")
        if dec_type not in ("stateless", "rwkv"):
            raise ValueError(dec_type)
        if cfg.frontend is None:
            raise NotImplementedError("a model without the default frontend is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.encoder.output_size
        n_feat = cfg.frontend.n_mels
        with torch.device(dev):
            self.encoder = make_encoder(cfg.encoder_type, cfg.encoder, n_feat, device=dev)
            decoder_cls = RWKVDecoder if dec_type == "rwkv" else StatelessDecoder
            self.decoder = decoder_cls(cfg.vocab_size, cfg.decoder)
            self.joint = JointNetwork(cfg.vocab_size, d, cfg.decoder.hidden_size, cfg.joint_size)
            if cfg.aux_ctc_weight > 0:
                self.ctc_head = nn.Linear(d, cfg.vocab_size)
            if cfg.normalize == "global_mvn":
                self.register_buffer("mvn_mean", torch.zeros(n_feat))
                self.register_buffer("mvn_inv_std", torch.ones(n_feat))

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S] waveform -> ([B, T', D] encoder output, [B] lengths)."""
        feats, feats_lengths = extract_features(self, speech, speech_lengths, rng)
        return self.encoder(feats, feats_lengths, rng)

    def joint_full(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """[B, T, De] x [B, U+1, Dd] -> [B, T, U+1, V] lattice logits."""
        return self.joint(enc[:, :, None, :], dec[:, None, :, :])

    def joint_step(self, enc_vec: torch.Tensor, dec_vec: torch.Tensor) -> torch.Tensor:
        """[B, De] x [B, Dd] -> [B, V]: one lattice cell (decoding)."""
        return self.joint(enc_vec, dec_vec)

    def decode_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """[B, U] labels -> [B, U+1, H] prediction-network outputs (decoding)."""
        return self.decoder(labels)

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor, text: torch.Tensor,
                text_lengths: torch.Tensor, rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """text [B, U] padded with ignore_id -> (loss, stats, weight)."""
        cfg = self.cfg
        enc, enc_lens = self.encode(speech, speech_lengths, rng)
        # the decoder and the RNN-T loss see 0 for pads; the CTC the raw text
        labels = torch.where(make_valid_mask(text_lengths, text.shape[1]), text, 0)
        dec = self.decoder(labels, rng)  # [B, U+1, H]
        logits = self.joint_full(enc, dec)
        loss_rnnt = rnnt_loss(logits, labels, enc_lens, text_lengths, cfg.blank_id)
        stats = {"loss_rnnt": loss_rnnt}
        loss = loss_rnnt
        if cfg.aux_ctc_weight > 0:
            loss_ctc = ctc_loss(self.ctc_head(enc), enc_lens, text, text_lengths, cfg.blank_id)
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
