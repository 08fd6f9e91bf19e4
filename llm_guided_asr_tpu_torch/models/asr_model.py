"""Hybrid CTC/attention ASR model (counterpart of llm_guided_asr_tpu/models/asr_model.py).

frontend -> SpecAug (training) -> normalize -> encoder -> {CTC head,
transformer decoder}; loss = ctc_weight * CTC + (1 - ctc_weight) *
label-smoothed attention CE, where CTC may mix in intermediate CTC over
chosen Conformer blocks (``interctc_weight``; the other encoders give no
taps, so the term is absent, as in JAX) and ``ctc_type: brctc`` charges
the final CTC (not the intermediate ones) the Bayes-risk delay
``brctc_risk_factor``.  ``forward`` returns ``(loss, stats,
weight)``: stats is a dict of float32 scalars, weight the batch size.
sos = eos = vocab_size - 1, blank 0, ignore_id -1, as in the reference.

This is phase 1 of the fork's two-phase training.  Ported: the encoders
of models/conformer.py make_encoder, the decoders of :func:`make_decoder`
(transformer, rnn, s4, lightconv, dynamicconv, hugging_face), the log-mel,
fused (ops/frontend.py FusedFrontend) and sliding-window frontends, the
frozen SSL frontend (``ssl_frontend``: a wav2vec2/HuBERT trunk of
models/ssl_encoders.py over the raw waveform, run without gradient and
always in eval mode, as JAX's ``stop_gradient`` freezes it), no frontend
(features or, for the ``*_hf`` encoders, the raw waveform in), the
multichannel WPE/MVDR frontend (``mc_frontend`` on a [B, S, C] batch, or
its reference channel when neither WPE nor the beamformer is on), the sinc
pre-encoder and the length-adaptor and BERT post-encoders
(models/preencoder.py, models/hf_encoder.py), utterance or global MVN, and
SpecAug.

Compute dtype (JAX's ``dtype``, ``train_dtype: bfloat16`` or ``use_amp``):
float32 or bfloat16, for every frontend, pre-encoder, encoder, decoder and
post-encoder.  Parameters, buffers and gradients stay float32; the features
are cast to the compute dtype at the encoder's input (JAX ``encode``), and
every block computes in its input's type (models/transformer.py), except
where flax computes a module in float32 inside a bfloat16 model (the LSTM
cells, built without a dtype; the state-space FFT convolutions).  The
log-mel, fused, sliding-window and multichannel frontends stay float32, as
JAX builds them without a dtype (JAX models/asr_model.py:169-190,
models/preencoder.py:29-44; JAX drops the log-mel DFT to one MXU pass for
a bfloat16 model, the port keeps the float32 product), and their features
are cast once at the encoder's input.  The frozen SSL frontend computes in
the compute dtype from the raw waveform on (JAX :167), so its features
are normalized in the compute dtype (the MVNs run in their input's type,
JAX :246-307) and enter the encoder as they are.  The CTC and attention
log-softmaxes and losses run in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerEncoder,
    make_encoder,
)
from llm_guided_asr_tpu_torch.models.rnn_decoder import RNNDecoder, RNNDecoderConfig
from llm_guided_asr_tpu_torch.models.s4_decoder import S4Decoder, S4DecoderConfig
from llm_guided_asr_tpu_torch.models.transformer import Dense, register_compute_dtype, to_compute
from llm_guided_asr_tpu_torch.models.transformer_decoder import (
    ConvTransformerDecoder,
    TransformerDecoder,
    TransformerDecoderConfig,
)
from llm_guided_asr_tpu_torch.ops.frontend import (
    FrontendConfig,
    FusedFrontend,
    MultichannelFrontend,
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

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def check_compute_dtype(dtype: torch.dtype) -> None:
    """float32 or bfloat16; any other dtype raises."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {dtype}; expected one of {COMPUTE_DTYPES}")


def embed_labels(decoder: nn.Module, labels: torch.Tensor) -> torch.Tensor:
    """A transducer prediction network's input: [B, U] labels -> [B, U+1,
    E] embedding rows of the blank context 0 and the labels (clipped into
    the vocabulary), in ``decoder``'s compute dtype (flax's ``nn.Embed``
    with ``dtype`` casts its table)."""
    y = torch.cat([torch.zeros_like(labels[:, :1]), labels], dim=1)
    return to_compute(decoder, decoder.embed(y.clamp(0, decoder.vocab_size - 1)))


@dataclasses.dataclass(frozen=True)
class ASRModelConfig:
    vocab_size: int
    frontend: Optional[FrontendConfig] = FrontendConfig()
    specaug: Optional[SpecAugConfig] = None
    normalize: str = "global_mvn"  # global_mvn | utterance_mvn | none
    encoder_type: str = "conformer"
    encoder: ConformerConfig = ConformerConfig()
    decoder_type: str = "transformer"
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    # decoder_type "hugging_face": models/hf_decoder.py HFCausalDecoderConfig
    hf_decoder: Optional[Any] = None
    # frozen SSL frontend: the models/ssl_encoders.py W2VConfig of a
    # wav2vec2/HuBERT trunk whose hidden states are the features
    ssl_frontend: Optional[Any] = None
    # the sinc pre-encoder's models/preencoder.py SincPreencoderConfig,
    # between normalization and the encoder
    preencoder: Optional[Any] = None
    # ("length_adaptor", LengthAdaptorConfig) or ("hugging_face_transformers",
    # HFPostEncoderConfig), after the encoder
    postencoder: Optional[Tuple[str, Any]] = None
    # feature width when there is no frontend (features in)
    input_size: Optional[int] = None
    ctc_weight: float = 0.5
    ctc_type: str = "builtin"  # builtin | builtin2 | brctc
    brctc_risk_factor: float = 0.0  # the delay risk of brctc (ops/losses.py BayesRiskCTC)
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


def raw_features(model: nn.Module, speech: torch.Tensor, speech_lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The log-mel frontend alone (the JAX models' ``_extract_feats``) for
    a model whose ``cfg`` has ``frontend``: features of a [B, S] waveform;
    with no frontend, ``speech`` itself.  :meth:`ASRModel.raw_features`
    adds the frontends only that model has."""
    f = model.cfg.frontend
    if f is None:
        return speech, speech_lengths
    return default_frontend(
        speech, speech_lengths, fs=f.fs, n_fft=f.n_fft, win_length=f.win_length,
        hop_length=f.hop_length, n_mels=f.n_mels, fmin=f.fmin, fmax=f.fmax,
        htk=f.htk, center=f.center, window=f.window,
    )


def normalize_features(model: nn.Module, feats: torch.Tensor, feats_lengths: torch.Tensor,
                       rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """SpecAug (training mode) -> normalization, for a model whose ``cfg``
    has ``specaug`` and ``normalize`` (and the ``mvn_*`` buffers for global
    MVN)."""
    cfg = model.cfg
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


def extract_features(model: nn.Module, speech: torch.Tensor, speech_lengths: torch.Tensor,
                     rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] waveform -> :func:`raw_features` -> :func:`normalize_features`.
    With no frontend (None), ``speech`` is already features [B, T, F]."""
    return normalize_features(model, *raw_features(model, speech, speech_lengths), rng)


def make_postencoder(spec: Tuple[str, Any], d: int) -> nn.Module:
    """The post-encoder of ``(kind, config)`` over a ``d``-wide encoder."""
    kind, post_cfg = spec
    if kind == "length_adaptor":
        from llm_guided_asr_tpu_torch.models.preencoder import LengthAdaptorPostEncoder

        return LengthAdaptorPostEncoder(post_cfg, d)
    if kind == "hugging_face_transformers":
        from llm_guided_asr_tpu_torch.models.hf_encoder import HFTransformersPostEncoder

        return HFTransformersPostEncoder(post_cfg, d)
    raise ValueError(f"unknown postencoder {kind!r}")


def make_decoder(cfg: ASRModelConfig, d: int, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> nn.Module:
    """The attention decoder of ``cfg.decoder_type`` over an encoder ``d``
    wide, with the JAX model's config mapping (models/asr_model.py:98-161):
    ``rnn`` takes hidden = ``decoder.linear_units``, layers =
    ``num_blocks``, embed_dim = min(D, 256) and att_dim = D; ``s4`` takes
    d_model = D, ``max(num_blocks, 1)`` layers, d_state 16 and the ``diag``
    kernel; D is ``encoder.output_size``; ``hugging_face`` is the pretrained
    causal LM of models/hf_decoder.py over a ``linear_in`` from d, computing
    in ``dtype``.  Each keeps the ``(enc, enc_lens, ys_in, ys_in_lens, rng,
    only_last)`` contract and computes in the encoder rows' type."""
    kind, dec, vocab = cfg.decoder_type, cfg.decoder, cfg.vocab_size
    if kind == "transformer":
        return TransformerDecoder(vocab, dec, d)
    if kind in ("lightconv", "dynamicconv"):
        return ConvTransformerDecoder(vocab, dec, d, dynamic=kind == "dynamicconv",
                                      device=device)
    if kind == "rnn":
        width = cfg.encoder.output_size
        return RNNDecoder(RNNDecoderConfig(vocab_size=vocab, hidden=dec.linear_units,
                                           layers=max(dec.num_blocks, 1),
                                           embed_dim=min(width, 256), att_dim=width),
                          d, device=device)
    if kind == "hugging_face":
        from llm_guided_asr_tpu_torch.models.hf_decoder import HFCausalDecoder

        return HFCausalDecoder(cfg.hf_decoder, d, device=device, dtype=dtype)
    if kind == "s4":
        return S4Decoder(S4DecoderConfig(vocab_size=vocab, d_model=cfg.encoder.output_size,
                                         n_layers=max(dec.num_blocks, 1),
                                         attention_heads=dec.attention_heads,
                                         linear_units=dec.linear_units,
                                         dropout_rate=dec.dropout_rate),
                         enc_dim=d, device=device)
    raise NotImplementedError(f"decoder_type={kind!r} is not ported yet")


class ASRModel(nn.Module):
    """The CTC/attention model, computing in ``dtype`` (float32, or
    bfloat16: see the module docstring).  ``.train()`` turns on dropout,
    SpecAug and batch statistics; the forward then needs a StepRNG."""

    def __init__(self, cfg: ASRModelConfig, device: Union[str, torch.device] = "cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.ctc_type not in ("builtin", "builtin2", "brctc"):
            raise ValueError(f"ctc_type={cfg.ctc_type!r}; known: builtin, builtin2, brctc")
        check_compute_dtype(dtype)
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            register_compute_dtype(self, dtype)
            if cfg.ssl_frontend is not None:
                from llm_guided_asr_tpu_torch.models.ssl_encoders import Wav2Vec2Encoder

                self.ssl_frontend = Wav2Vec2Encoder(cfg.ssl_frontend, dtype=dtype).eval()
                n_feat = cfg.ssl_frontend.hidden_size
            elif cfg.frontend is not None:
                n_feat = cfg.frontend.output_dim
                if cfg.frontend.fused:
                    self.fused_frontend = FusedFrontend(cfg.frontend.fused, cfg.frontend.proj_dim,
                                                        cfg.frontend.fs)
                if cfg.frontend.multichannel:
                    self.mc_frontend = MultichannelFrontend(cfg.frontend)
            else:
                n_feat = None
            enc_in = n_feat if n_feat is not None else (cfg.input_size or 1)
            if cfg.preencoder is not None:
                from llm_guided_asr_tpu_torch.models.preencoder import LightweightSincConvs

                self.preencoder = LightweightSincConvs(cfg.preencoder)
                enc_in = self.preencoder.output_size
            self.encoder = make_encoder(cfg.encoder_type, cfg.encoder, enc_in, device=dev,
                                        dtype=dtype)
            d = self.encoder.output_size
            if cfg.postencoder is not None:
                self.postencoder = make_postencoder(cfg.postencoder, d)
                d = self.postencoder.output_size
            if cfg.ctc_weight < 1.0:
                self.decoder = make_decoder(cfg, d, dev, dtype)
            if cfg.ctc_weight > 0.0:
                self.ctc_head = Dense(d, cfg.vocab_size)
            if cfg.normalize == "global_mvn":
                # one statistic wide without a frontend, as in JAX
                dim = n_feat if n_feat is not None else 1
                self.register_buffer("mvn_mean", torch.zeros(dim))
                self.register_buffer("mvn_inv_std", torch.ones(dim))

    def train(self, mode: bool = True) -> "ASRModel":
        """As ``nn.Module.train``; the frozen SSL trunk stays in eval mode."""
        super().train(mode)
        if self.cfg.ssl_frontend is not None:
            self.ssl_frontend.eval()
        return self

    def raw_features(self, speech: torch.Tensor, speech_lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The frontend alone (JAX ``_extract_feats``): the frozen SSL
        trunk's hidden states (no gradient), the multichannel frontend of a
        [B, S, C] batch (or its reference channel), the fused frontend, the
        sliding window's raw frames, or :func:`raw_features`' log-mel
        features."""
        if self.cfg.ssl_frontend is not None and speech.dim() == 2:
            with torch.no_grad():
                return self.ssl_frontend(speech, speech_lengths)
        f = self.cfg.frontend
        if f is not None and speech.dim() == 3:
            if f.multichannel:
                return self.mc_frontend(speech, speech_lengths)
            speech = speech[..., f.ref_channel]
        if f is not None and f.fused:
            return self.fused_frontend(speech, speech_lengths)
        if f is not None and f.type == "sliding_window":
            from llm_guided_asr_tpu_torch.models.preencoder import sliding_window

            return sliding_window(speech, speech_lengths, win_length=f.win_length or 400,
                                  hop_length=f.hop_length)
        return raw_features(self, speech, speech_lengths)

    def collect_feats(self, speech: torch.Tensor, speech_lengths: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        feats, feats_lengths = self.raw_features(speech, speech_lengths)
        return {"feats": feats, "feats_lengths": feats_lengths}

    def _encoder_input(self, speech, speech_lengths, rng):
        feats, feats_lengths = normalize_features(
            self, *self.raw_features(speech, speech_lengths), rng)
        feats = to_compute(self, feats)
        if self.cfg.preencoder is not None:
            feats = self.preencoder(feats, rng)
        return feats, feats_lengths

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               rng: Optional[StepRNG] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S] waveform -> ([B, T', D] encoder output, [B] lengths)."""
        enc, enc_lens, _ = self.encode_with_intermediates(speech, speech_lengths, rng)
        return enc, enc_lens

    def encode_with_intermediates(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                                  rng: Optional[StepRNG] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        """``encode`` plus the intermediate-CTC taps (empty without
        ``encoder.interctc_layer_idx``).  Only the Conformer gives taps; with
        any other encoder ``interctc_weight`` adds no term, as in JAX.  The
        post-encoder runs on the encoder's output, not on the taps."""
        feats, feats_lengths = self._encoder_input(speech, speech_lengths, rng)
        if self.cfg.encoder.interctc_layer_idx and isinstance(self.encoder, ConformerEncoder):
            enc, enc_lens, taps = self.encoder.forward_with_intermediates(feats, feats_lengths,
                                                                          rng)
        else:
            (enc, enc_lens), taps = self.encoder(feats, feats_lengths, rng), ()
        if self.cfg.postencoder is not None:
            enc, enc_lens = self.postencoder(enc, enc_lens, rng)
        return enc, enc_lens, taps

    def ctc_logits(self, encoder_out: torch.Tensor) -> torch.Tensor:
        """The CTC head's logits, float32 (at least) and not rounded: every
        caller casts them to float32 at once (models/transformer.py Dense
        ``f32_out``)."""
        return self.ctc_head(to_compute(self, encoder_out), f32_out=True)

    def ctc_log_softmax(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_logits(encoder_out).float(), dim=-1)

    def decoder_logits(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths,
                       rng: Optional[StepRNG] = None, only_last: bool = False) -> torch.Tensor:
        return self.decoder(to_compute(self, encoder_out), encoder_out_lengths, ys_in,
                            ys_in_lengths, rng, only_last=only_last)

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
            risk = cfg.brctc_risk_factor if cfg.ctc_type == "brctc" else 0.0
            loss_ctc = ctc_loss(self.ctc_logits(enc_out), enc_lens, text, text_lengths,
                                cfg.blank_id, time_risk=risk)
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
