"""LLM-guided speech translation (counterpart of llm_guided_asr_tpu/models/llm_guided_st.py).

The fork's second headline model (espnet2/st/llm_guided_st_model.py:41):
the guided ASR model's machinery (models/llm_guided.py), with the CTC head
over the *source* vocabulary, whose greedy first pass goes into the
``((HYP))`` prompt, and the guided decoder emitting the *target*
translation over the LLM vocabulary, plus auxiliary ASR losses on the
source text:

  loss = (1 - asr_weight) * st_att
       + asr_weight * (mtlalpha * asr_ctc + (1 - mtlalpha) * asr_att)

(llm_guided_st_model.py:264-290); ``asr_att`` is the optional
``extra_asr_decoder``, a standard transformer decoder over the source
vocabulary.  As in the JAX model:

- the encoder runs in eval mode whatever ``.train()`` says (JAX:
  ``deterministic=True``, :139), so ST training has no encoder dropout;
  SpecAug still runs in training mode;
- the first pass's source-vocabulary ids are packed into the prompt as
  LLM ids (:154-157); an id at or past the LLM vocabulary raises here,
  where JAX's gather clamps it silently;
- the LLM is frozen and its hidden states carry no gradient (:159);
- sos/eos of the translation are the LLM's response delimiters, the
  source side's ``src_vocab_size - 1`` (:64-78).

Decoding (bin/st_inference.py) takes the full-prefix scorer, as the JAX
package does: ``decoder_logits(..., only_last=True)`` projects the last
position of each row only, where the JAX model computes every position
and the scorer takes position ``lens - 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig
from llm_guided_asr_tpu_torch.models.llm.prompt import PromptTemplate
from llm_guided_asr_tpu_torch.models.llm_guided import LLMGuidedASRModel
from llm_guided_asr_tpu_torch.models.transformer_decoder import (
    TransformerDecoder,
    TransformerDecoderConfig,
)
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.losses import (
    accuracy,
    add_sos_eos,
    ctc_loss,
    label_smoothing_loss,
)
from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig
from llm_guided_asr_tpu_torch.utils.masks import causal_attn_mask, make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG


@dataclasses.dataclass(frozen=True)
class LLMGuidedSTConfig:
    vocab_size: int  # target vocabulary = the LLM's
    src_vocab_size: int
    llm: LlamaConfig
    prompt: PromptTemplate
    frontend: Optional[FrontendConfig] = FrontendConfig()
    specaug: Optional[SpecAugConfig] = None
    normalize: str = "global_mvn"
    encoder_type: str = "conformer"
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    extra_asr_decoder: Optional[TransformerDecoderConfig] = None
    asr_weight: float = 0.3
    mtlalpha: float = 0.5  # the CTC's weight inside the ASR loss
    lsm_weight: float = 0.0
    length_normalized_loss: bool = False
    ignore_id: int = -1
    blank_id: int = 0
    # the feature width when ``frontend`` is None
    input_size: Optional[int] = None

    # the guided ASR model's options that the ST model does not have
    first_pass_pad_frames = False
    ctc_vocab_size = None
    llm_score_mode = "hidden"

    @property
    def n_feat(self) -> int:
        if self.frontend is not None:
            return self.frontend.n_mels
        if self.input_size is None:
            raise ValueError("a model without a frontend needs input_size")
        return self.input_size

    @property
    def ctc_dim(self) -> int:
        return self.src_vocab_size

    @property
    def sos_id(self) -> int:
        return self.prompt.start_of_response_id

    @property
    def eos_id(self) -> int:
        return self.prompt.end_of_response_id

    @property
    def src_sos_id(self) -> int:
        return self.src_vocab_size - 1

    @property
    def src_eos_id(self) -> int:
        return self.src_vocab_size - 1


class LLMGuidedSTModel(LLMGuidedASRModel):
    """The ST model: the guided ASR model's modules (encoder, source-vocab
    ``ctc_head``, ``llm``, ``embed``, ``block_{i}``, ``after_norm``,
    ``output_layer``) plus the optional ``extra_asr_decoder``."""

    def __init__(self, cfg: LLMGuidedSTConfig, llm_dtype=torch.bfloat16,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(cfg, llm_dtype=llm_dtype, device=device)
        if cfg.extra_asr_decoder is not None:
            with torch.device(self.ctc_head.weight.device):
                self.extra_asr_decoder = TransformerDecoder(
                    cfg.src_vocab_size, cfg.extra_asr_decoder, cfg.encoder.output_size)

    def _first_pass_hyp(self, encoder_out, encoder_out_lengths):
        """The source-vocab greedy CTC hypothesis, used as LLM ids."""
        hyp, hyp_lengths = super()._first_pass_hyp(encoder_out, encoder_out_lengths)
        cfg = self.cfg
        if cfg.src_vocab_size > cfg.vocab_size and hyp.numel():
            top = int(hyp.max())
            if top >= cfg.vocab_size:
                raise ValueError(
                    f"the source-vocab first pass gave id {top}, past the LLM's {cfg.vocab_size} "
                    f"tokens: the prompt cannot hold it (the JAX model clamps it silently)")
        return hyp, hyp_lengths

    def decoder_logits(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths,
                       rng: Optional[StepRNG] = None, only_last: bool = False) -> torch.Tensor:
        """The guided decoder over the translation prefix -> [B, L, V]
        logits, or [B, V] at each row's last position with ``only_last``."""
        x = self.embed(self._llm_response_states(encoder_out, encoder_out_lengths, ys_in,
                                                 ys_in_lengths))
        tgt_mask = causal_attn_mask(ys_in_lengths, ys_in.shape[1])
        memory_mask = make_valid_mask(encoder_out_lengths, encoder_out.shape[1])[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, encoder_out, memory_mask, rng=rng)
        x = self.after_norm(x)
        if only_last:
            x = x[torch.arange(x.shape[0], device=x.device), ys_in_lengths - 1]
        return self.output_layer(x)

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor, text: torch.Tensor,
                text_lengths: torch.Tensor, src_text: Optional[torch.Tensor] = None,
                src_text_lengths: Optional[torch.Tensor] = None,
                rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """text [B, L]: the translation in LLM ids, src_text [B, Ls]: the
        source transcript in source ids (both padded with ignore_id) ->
        (loss, stats, weight)."""
        cfg = self.cfg
        enc, enc_lens = self.encode(speech, speech_lengths, rng)
        stats: Dict[str, torch.Tensor] = {}
        ys_in, ys_out = add_sos_eos(text, text_lengths, cfg.sos_id, cfg.eos_id, cfg.ignore_id)
        st_logits = self.decoder_logits(enc, enc_lens, ys_in, text_lengths + 1, rng)
        loss_st = label_smoothing_loss(st_logits, ys_out, cfg.lsm_weight, cfg.ignore_id,
                                       cfg.length_normalized_loss)
        stats["loss_st_att"] = loss_st
        stats["acc"] = accuracy(st_logits, ys_out, cfg.ignore_id)
        loss = loss_st
        if cfg.asr_weight > 0.0 and src_text is not None:
            zero = torch.zeros((), dtype=torch.float32, device=enc.device)
            loss_asr_ctc = loss_asr_att = zero
            if cfg.mtlalpha > 0.0:
                loss_asr_ctc = ctc_loss(self.ctc_head(enc), enc_lens, src_text, src_text_lengths,
                                        cfg.blank_id)
                stats["loss_asr_ctc"] = loss_asr_ctc
            if cfg.mtlalpha < 1.0 and cfg.extra_asr_decoder is not None:
                s_in, s_out = add_sos_eos(src_text, src_text_lengths, cfg.src_sos_id,
                                          cfg.src_eos_id, cfg.ignore_id)
                asr_logits = self.extra_asr_decoder(enc, enc_lens, s_in, src_text_lengths + 1,
                                                    rng=rng)
                loss_asr_att = label_smoothing_loss(asr_logits, s_out, cfg.lsm_weight,
                                                    cfg.ignore_id, cfg.length_normalized_loss)
                stats["loss_asr_att"] = loss_asr_att
            if cfg.mtlalpha == 1.0:
                loss_asr = loss_asr_ctc
            elif cfg.mtlalpha == 0.0:
                loss_asr = loss_asr_att
            else:
                loss_asr = cfg.mtlalpha * loss_asr_ctc + (1 - cfg.mtlalpha) * loss_asr_att
            stats["loss_asr"] = loss_asr
            loss = (1 - cfg.asr_weight) * loss_st + cfg.asr_weight * loss_asr
        stats["loss"] = loss
        return loss, stats, torch.tensor(float(speech.shape[0]), device=enc.device)
