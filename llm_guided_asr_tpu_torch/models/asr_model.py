"""Hybrid CTC/attention ASR model (counterpart of llm_guided_asr_tpu/models/asr_model.py).

frontend -> SpecAug (training) -> normalize -> Conformer -> {CTC head,
transformer decoder}; loss = ctc_weight * CTC + (1 - ctc_weight) *
label-smoothed attention CE, where CTC may mix in intermediate CTC over
chosen encoder blocks (``interctc_weight``).  ``forward`` returns ``(loss, stats,
weight)``: stats is a dict of float32 scalars, weight the batch size.
sos = eos = vocab_size - 1, blank 0, ignore_id -1, as in the reference.

This is phase 1 of the fork's two-phase training.  Only the flagship's
choices are ported: the Conformer encoder, the transformer decoder, the
default log-mel frontend, utterance or global MVN, and SpecAug; every
other choice raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.models.transformer_decoder import (
    TransformerDecoder,
    TransformerDecoderConfig,
)
from llm_guided_asr_tpu_torch.ops.frontend import (
    FrontendConfig,
    default_frontend,
    global_mvn,
    utterance_mvn,
)
from llm_guided_asr_tpu_torch.ops.losses import (
    accuracy,
    add_sos_eos,
    ctc_loss,
    label_smoothing_loss,
)
from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig, specaug
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.rng import StepRNG


@dataclasses.dataclass(frozen=True)
class ASRModelConfig:
    vocab_size: int
    frontend: FrontendConfig = FrontendConfig()
    specaug: Optional[SpecAugConfig] = None
    normalize: str = "global_mvn"  # global_mvn | utterance_mvn | none
    encoder_type: str = "conformer"
    encoder: ConformerConfig = ConformerConfig()
    decoder_type: str = "transformer"
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    ctc_weight: float = 0.5
    ctc_type: str = "builtin"  # builtin | builtin2; brctc is not ported
    # intermediate CTC over the encoder.interctc_layer_idx taps, through the
    # shared CTC head: loss_ctc = (1 - w) * ctc + w * mean(inter ctc)
    interctc_weight: float = 0.0
    lsm_weight: float = 0.0
    length_normalized_loss: bool = False
    ignore_id: int = -1
    blank_id: int = 0
    sos: Optional[int] = None  # default vocab_size - 1
    eos: Optional[int] = None

    @property
    def sos_id(self) -> int:
        return self.vocab_size - 1 if self.sos is None else self.sos

    @property
    def eos_id(self) -> int:
        return self.vocab_size - 1 if self.eos is None else self.eos


def extract_features(model: nn.Module, speech: torch.Tensor, speech_lengths: torch.Tensor,
                     rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] waveform -> log-mel -> SpecAug (training mode) -> normalized
    features, for a model whose ``cfg`` has ``frontend``, ``specaug`` and
    ``normalize`` (and the ``mvn_*`` buffers for global MVN).  With no
    frontend (None), ``speech`` is already features [B, T, F]."""
    cfg = model.cfg
    f = cfg.frontend
    if f is None:
        feats, feats_lengths = speech, speech_lengths
    else:
        feats, feats_lengths = default_frontend(
            speech, speech_lengths, fs=f.fs, n_fft=f.n_fft, win_length=f.win_length,
            hop_length=f.hop_length, n_mels=f.n_mels, fmin=f.fmin, fmax=f.fmax,
            htk=f.htk, center=f.center, window=f.window,
        )
    if cfg.specaug is not None and model.training:
        if rng is None:
            raise ValueError("SpecAug in training mode needs a StepRNG")
        feats = specaug(rng.device, feats, feats_lengths, cfg.specaug)
    if cfg.normalize == "global_mvn":
        feats = global_mvn(feats, model.mvn_mean, model.mvn_inv_std, feats_lengths)
    elif cfg.normalize == "utterance_mvn":
        feats = utterance_mvn(feats, feats_lengths)
    elif cfg.normalize != "none":
        raise NotImplementedError(f"normalize={cfg.normalize!r} is not ported yet")
    return feats, feats_lengths


class ASRModel(nn.Module):
    """The CTC/attention model, float32.  ``.train()`` turns on dropout,
    SpecAug and batch statistics; the forward then needs a StepRNG."""

    def __init__(self, cfg: ASRModelConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        if cfg.decoder_type != "transformer":
            raise NotImplementedError(f"decoder_type={cfg.decoder_type!r} is not ported yet")
        if cfg.frontend is None:
            raise NotImplementedError("a model without the default frontend is not ported yet")
        if cfg.ctc_type not in ("builtin", "builtin2"):
            raise NotImplementedError(f"ctc_type={cfg.ctc_type!r} is not ported yet")
        if cfg.encoder.interctc_layer_idx and cfg.encoder_type != "conformer":
            raise NotImplementedError(f"intermediate CTC with encoder_type="
                                      f"{cfg.encoder_type!r} is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.encoder.output_size
        n_feat = cfg.frontend.n_mels
        with torch.device(dev):
            self.encoder = make_encoder(cfg.encoder_type, cfg.encoder, n_feat, device=dev)
            if cfg.ctc_weight < 1.0:
                self.decoder = TransformerDecoder(cfg.vocab_size, cfg.decoder, d)
            if cfg.ctc_weight > 0.0:
                self.ctc_head = nn.Linear(d, cfg.vocab_size)
            if cfg.normalize == "global_mvn":
                self.register_buffer("mvn_mean", torch.zeros(n_feat))
                self.register_buffer("mvn_inv_std", torch.ones(n_feat))

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S] waveform -> ([B, T', D] encoder output, [B] lengths)."""
        feats, feats_lengths = extract_features(self, speech, speech_lengths, rng)
        return self.encoder(feats, feats_lengths, rng)

    def encode_with_intermediates(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                                  rng: Optional[StepRNG] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        """``encode`` plus the intermediate-CTC taps (empty without
        ``encoder.interctc_layer_idx``)."""
        if not self.cfg.encoder.interctc_layer_idx:
            return (*self.encode(speech, speech_lengths, rng), ())
        feats, feats_lengths = extract_features(self, speech, speech_lengths, rng)
        return self.encoder.forward_with_intermediates(feats, feats_lengths, rng)

    def ctc_logits(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return self.ctc_head(encoder_out)

    def ctc_log_softmax(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_head(encoder_out).float(), dim=-1)

    def decoder_logits(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths,
                       rng: Optional[StepRNG] = None, only_last: bool = False) -> torch.Tensor:
        return self.decoder(encoder_out, encoder_out_lengths, ys_in, ys_in_lengths, rng,
                            only_last=only_last)

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor, text: torch.Tensor,
                text_lengths: torch.Tensor, rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """text [B, L] padded with ignore_id -> (loss, stats, weight)."""
        cfg = self.cfg
        enc_out, enc_lens, taps = self.encode_with_intermediates(speech, speech_lengths, rng)
        stats: Dict[str, torch.Tensor] = {}
        zero = torch.zeros((), dtype=torch.float32, device=enc_out.device)
        loss_ctc = loss_att = zero
        if cfg.ctc_weight > 0.0:
            loss_ctc = ctc_loss(self.ctc_logits(enc_out), enc_lens, text, text_lengths,
                                cfg.blank_id)
            stats["loss_ctc"] = loss_ctc
            if cfg.interctc_weight > 0.0 and taps:
                inter = torch.stack([ctc_loss(self.ctc_logits(h), enc_lens, text, text_lengths,
                                              cfg.blank_id) for h in taps]).mean()
                stats["loss_interctc"] = inter
                loss_ctc = (1 - cfg.interctc_weight) * loss_ctc + cfg.interctc_weight * inter
        if cfg.ctc_weight < 1.0:
            ys_in, ys_out = add_sos_eos(text, text_lengths, cfg.sos_id, cfg.eos_id, cfg.ignore_id)
            dec_logits = self.decoder_logits(enc_out, enc_lens, ys_in, text_lengths + 1, rng)
            loss_att = label_smoothing_loss(dec_logits, ys_out, cfg.lsm_weight, cfg.ignore_id,
                                            cfg.length_normalized_loss)
            stats["loss_att"] = loss_att
            stats["acc"] = accuracy(dec_logits, ys_out, cfg.ignore_id)
        if cfg.ctc_weight == 0.0:
            loss = loss_att
        elif cfg.ctc_weight == 1.0:
            loss = loss_ctc
        else:
            loss = cfg.ctc_weight * loss_ctc + (1.0 - cfg.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats, torch.tensor(float(speech.shape[0]), device=enc_out.device)
