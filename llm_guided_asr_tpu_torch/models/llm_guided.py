"""LLM-guided ASR model (counterpart of llm_guided_asr_tpu/models/llm_guided.py).

waveform -> frontend -> Conformer -> greedy CTC first pass -> ((HYP)) prompt
-> frozen Llama -> response hidden states -> Linear(llm_hidden -> D)
("embed") -> 6-block guided decoder cross-attending to the encoder ->
logits over the LLM vocabulary.

``forward`` is the phase-2 training loss: the encoder stays in eval mode
whatever ``.train()`` says (the recipe freezes it), the LLM is frozen and
its hidden states carry no gradient, and the guided decoder's dropout
follows ``.train()``.  ``decode_prefix``/``decode_step`` are the cached
decoding pair the beam search calls: the prompt KV is computed once per
utterance and shared by the beam; each step runs one Llama token per beam
and one position through the guided decoder.  Only the ``hidden`` score
mode is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.asr_model import extract_features
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel
from llm_guided_asr_tpu_torch.models.llm.prompt import (
    PromptTemplate,
    gather_response,
    pack_prompt,
)
from llm_guided_asr_tpu_torch.models.transformer_decoder import (
    TransformerDecoderConfig,
    decoder_layers,
)
from llm_guided_asr_tpu_torch.ops.frontend import FrontendConfig
from llm_guided_asr_tpu_torch.ops.losses import (
    accuracy,
    add_sos_eos,
    ctc_loss,
    label_smoothing_loss,
)
from llm_guided_asr_tpu_torch.ops.specaug import SpecAugConfig
from llm_guided_asr_tpu_torch.search.greedy import ctc_greedy_decode
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import causal_attn_mask, make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG


@dataclasses.dataclass(frozen=True)
class LLMGuidedASRConfig:
    vocab_size: int  # = LLM vocab size
    llm: LlamaConfig
    prompt: PromptTemplate
    # None: the model takes features [B, T, input_size], not waveforms
    frontend: Optional[FrontendConfig] = FrontendConfig()
    specaug: Optional[SpecAugConfig] = None
    normalize: str = "global_mvn"  # global_mvn | utterance_mvn | none
    encoder_type: str = "conformer"
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    ctc_weight: float = 0.3
    lsm_weight: float = 0.0
    length_normalized_loss: bool = False
    ignore_id: int = -1
    blank_id: int = 0
    # reference-compat quirk: the reference's training-time first-pass CTC
    # collapse runs over the whole padded encoder output, so pad frames
    # can leak tokens into shorter utterances' prompts.  False (the
    # default) trims to the valid frames; True restores bit-parity with the
    # reference (tests/parity/golden_llm_guided.npz)
    first_pass_pad_frames: bool = False
    # the feature width when ``frontend`` is None (the JAX model reads it
    # off its input); otherwise the frontend's n_mels
    input_size: Optional[int] = None

    @property
    def n_feat(self) -> int:
        if self.frontend is not None:
            return self.frontend.n_mels
        if self.input_size is None:
            raise ValueError("a model without a frontend needs input_size")
        return self.input_size

    @property
    def sos_id(self) -> int:
        return self.prompt.start_of_response_id

    @property
    def eos_id(self) -> int:
        return self.prompt.end_of_response_id


class LLMGuidedASRModel(nn.Module):
    """Serving-path model; the ASR side runs in float32, the LLM in ``llm_dtype``."""

    def __init__(self, cfg: LLMGuidedASRConfig, llm_dtype=torch.bfloat16,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.encoder.output_size
        n_feat = cfg.n_feat
        with torch.device(dev):
            self.encoder = make_encoder(cfg.encoder_type, cfg.encoder, n_feat, device=dev)
            self.ctc_head = nn.Linear(d, cfg.vocab_size)
            self.llm = LlamaModel(cfg.llm, dtype=llm_dtype, device=dev)
            self.embed = nn.Linear(cfg.llm.hidden_size, d)
            for i, layer in enumerate(decoder_layers(cfg.decoder, d)):
                setattr(self, f"block_{i}", layer)
            # a bare flax nn.LayerNorm in the JAX model: epsilon 1e-6
            self.after_norm = nn.LayerNorm(d, eps=1e-6)
            self.output_layer = nn.Linear(d, cfg.vocab_size)
            if cfg.normalize == "global_mvn":
                self.register_buffer("mvn_mean", torch.zeros(n_feat))
                self.register_buffer("mvn_inv_std", torch.ones(n_feat))

    @property
    def decoders(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.decoder.num_blocks)]

    def train(self, mode: bool = True):
        """Train mode reaches the guided decoder only: the phase-2 recipe
        keeps the encoder in eval mode (batch-norm running statistics, no
        dropout) and the LLM is frozen."""
        super().train(mode)
        self.encoder.eval()
        self.llm.eval()
        return self

    # ------------------------------------------------------------------
    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
               rng: Optional[StepRNG] = None):
        """[B, S] waveform (or [B, T, input_size] features when the config
        has no frontend) -> ([B, T', D] encoder output, [B] lengths);
        SpecAug runs in training mode, the encoder always in eval mode."""
        feats, feats_lengths = extract_features(self, speech, speech_lengths, rng)
        return self.encoder(feats, feats_lengths)

    def ctc_log_softmax(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_head(encoder_out).float(), dim=-1)

    def _first_pass_hyp(self, encoder_out, encoder_out_lengths):
        """Greedy CTC hypothesis in LLM-vocab ids, over the valid frames, or
        over every frame with ``first_pass_pad_frames``."""
        cfg = self.cfg
        if cfg.first_pass_pad_frames:
            encoder_out_lengths = torch.full_like(encoder_out_lengths, encoder_out.shape[1])
        return ctc_greedy_decode(
            self.ctc_log_softmax(encoder_out), encoder_out_lengths,
            blank_id=cfg.blank_id, pad_id=cfg.prompt.pad_id,
        )

    def _llm_response_states(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths):
        """First-pass CTC -> prompt pack -> frozen LLM -> response hidden states."""
        hyp, hyp_lengths = self._first_pass_hyp(encoder_out, encoder_out_lengths)
        ids, valid, resp_start = pack_prompt(self.cfg.prompt, hyp, hyp_lengths, ys_in, ys_in_lengths)
        with torch.no_grad():  # the LLM is frozen: no backward graph through it
            hidden, _ = self.llm(ids, valid)
        resp = gather_response(hidden, resp_start, ys_in.shape[1]).float()
        resp_valid = make_valid_mask(ys_in_lengths, ys_in.shape[1])
        return resp.masked_fill(~resp_valid[..., None], 0.0)

    def decoder_logits(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths,
                       rng: Optional[StepRNG] = None):
        """Full (uncached) guided decoder forward -> [B, L, V] logits."""
        x = self.embed(self._llm_response_states(
            encoder_out, encoder_out_lengths, ys_in, ys_in_lengths))
        tgt_mask = causal_attn_mask(ys_in_lengths, ys_in.shape[1])
        memory_mask = make_valid_mask(encoder_out_lengths, encoder_out.shape[1])[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, encoder_out, memory_mask, rng=rng)
        return self.output_layer(self.after_norm(x))

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor, text: torch.Tensor,
                text_lengths: torch.Tensor, rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """Phase-2 loss: text [B, L] (LLM-vocab ids padded with ignore_id)
        -> (loss, stats, weight), ctc_weight * CTC + (1 - ctc_weight) *
        label-smoothed CE of the guided decoder."""
        cfg = self.cfg
        enc_out, enc_lens = self.encode(speech, speech_lengths, rng)
        stats: Dict[str, torch.Tensor] = {}
        loss_ctc = torch.zeros((), dtype=torch.float32, device=enc_out.device)
        if cfg.ctc_weight > 0.0:
            loss_ctc = ctc_loss(self.ctc_head(enc_out), enc_lens, text, text_lengths,
                                cfg.blank_id)
            stats["loss_ctc"] = loss_ctc
        ys_in, ys_out = add_sos_eos(text, text_lengths, cfg.sos_id, cfg.eos_id, cfg.ignore_id)
        dec_logits = self.decoder_logits(enc_out, enc_lens, ys_in, text_lengths + 1, rng)
        loss_att = label_smoothing_loss(dec_logits, ys_out, cfg.lsm_weight, cfg.ignore_id,
                                        cfg.length_normalized_loss)
        stats["loss_att"] = loss_att
        stats["acc"] = accuracy(dec_logits, ys_out, cfg.ignore_id)
        if cfg.ctc_weight == 0.0:
            loss = loss_att
        else:
            loss = cfg.ctc_weight * loss_ctc + (1.0 - cfg.ctc_weight) * loss_att
        stats["loss"] = loss
        return loss, stats, torch.tensor(float(speech.shape[0]), device=enc_out.device)

    # ------------------------------------------------------------------
    def decode_prefix(self, encoder_out, encoder_out_lengths, beam: int, resp_max: int) -> Dict:
        """First pass + prompt-only LLM forward; build the decoding state.

        The prompt KV is computed once and copied into per-beam float32
        buffers of prompt_len + resp_max positions (float32 even for a
        bfloat16 LLM, as in the JAX model).  The guided decoder's memory
        K/V projections are utterance-constant and computed here once.
        """
        cfg = self.cfg
        hyp, hyp_lengths = self._first_pass_hyp(encoder_out, encoder_out_lengths)
        b, dev = encoder_out.shape[0], encoder_out.device
        empty = torch.zeros((b, 0), dtype=torch.int64, device=dev)
        ids, valid, _ = pack_prompt(cfg.prompt, hyp, hyp_lengths, empty,
                                    torch.zeros((b,), dtype=torch.int64, device=dev))
        _, cache = self.llm(ids, valid)
        tp = ids.shape[1]
        tc = tp + resp_max
        hkv, hd = cfg.llm.num_key_value_heads, cfg.llm.head_dim
        k_bufs, v_bufs = [], []
        for k, v in cache:
            kb = torch.zeros((beam, tc, hkv, hd), dtype=torch.float32, device=dev)
            vb = torch.zeros((beam, tc, hkv, hd), dtype=torch.float32, device=dev)
            kb[:, :tp] = k[:1].float()
            vb[:, :tp] = v[:1].float()
            k_bufs.append(kb)
            v_bufs.append(vb)
        kv_valid = torch.zeros((beam, tc), dtype=torch.bool, device=dev)
        kv_valid[:, :tp] = valid[:1]
        gd_mem = [layer.project_mem_kv(encoder_out) for layer in self.decoders]
        return {
            "k": k_bufs,
            "v": v_bufs,
            "kv_valid": kv_valid,
            "prompt_nvalid": valid[0].sum(),
            "prompt_len": tp,
            "gd_mem_k": torch.stack([m[0] for m in gd_mem]),  # [L, 1, T, H, dk]
            "gd_mem_v": torch.stack([m[1] for m in gd_mem]),
            "gd_xs": torch.zeros((len(gd_mem), beam, resp_max, encoder_out.shape[2]),
                                 dtype=torch.float32, device=dev),
        }

    def decode_step(
        self,
        encoder_out: torch.Tensor,  # [1, T, D] (one utterance)
        encoder_out_lengths: torch.Tensor,  # [1]
        state: Dict,
        last_token: torch.Tensor,  # [K] most recent response token (sos at step 0)
        step: int,  # response position
    ) -> Tuple[torch.Tensor, Dict]:
        """One cached step: the LLM on the new token only, then one position
        through the guided decoder -> log-probs [K, V].

        Updates the state IN PLACE: the new token's LLM k/v go into the KV
        buffers at prompt_len + step (the JAX model writes the same values
        with dynamic_update_slice), its decoder inputs into gd_xs.
        """
        beam = state["k"][0].shape[0]
        resp_max = state["gd_xs"].shape[2]
        write = state["prompt_len"] + step
        dev = encoder_out.device
        positions = (state["prompt_nvalid"] + step).reshape(1, 1).expand(beam, 1)
        hidden, _ = self.llm(
            last_token[:, None],
            torch.ones((beam, 1), dtype=torch.bool, device=dev),
            cache=list(zip(state["k"], state["v"])),
            cache_valid=state["kv_valid"],
            positions=positions,
            cache_write_pos=write,
        )
        state["kv_valid"][:, write] = True

        x_cur = self.embed(hidden.float())  # [K, 1, D]
        tgt_mask = (torch.arange(resp_max, device=dev) <= step)[None, None, :].expand(beam, 1, resp_max)
        t_enc = encoder_out.shape[1]
        mem = encoder_out[0:1].expand(beam, t_enc, encoder_out.shape[2])
        mem_mask = (torch.arange(t_enc, device=dev) < encoder_out_lengths[0])[None, None, :]
        mem_mask = mem_mask.expand(beam, 1, t_enc)
        gd_xs = state["gd_xs"]
        for i, layer in enumerate(self.decoders):
            gd_xs[i, :, step] = x_cur[:, 0]
            mem_k = state["gd_mem_k"][i].expand(beam, -1, -1, -1)
            mem_v = state["gd_mem_v"][i].expand(beam, -1, -1, -1)
            x_cur = layer(x_cur, tgt_mask, mem, mem_mask, self_kv=gd_xs[i], mem_kv=(mem_k, mem_v))
        logits = self.output_layer(self.after_norm(x_cur))[:, 0]
        return F.log_softmax(logits.float(), dim=-1), state
