"""LLM-guided ASR model, serving path (counterpart of llm_guided_asr_tpu/models/llm_guided.py).

waveform -> frontend -> Conformer -> greedy CTC first pass -> ((HYP)) prompt
-> frozen Llama -> response hidden states -> Linear(llm_hidden -> D)
("embed") -> 6-block guided decoder cross-attending to the encoder ->
logits over the LLM vocabulary.

``decode_prefix``/``decode_step`` are the cached decoding pair the beam
search calls: the prompt KV is computed once per utterance and shared by
the beam; each step runs one Llama token per beam and one position through
the guided decoder.  Only the ``hidden`` score mode is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel
from llm_guided_asr_tpu_torch.models.llm.prompt import (
    PromptTemplate,
    gather_response,
    pack_prompt,
)
from llm_guided_asr_tpu_torch.models.transformer import DecoderLayer
from llm_guided_asr_tpu_torch.models.transformer_decoder import TransformerDecoderConfig
from llm_guided_asr_tpu_torch.ops.frontend import (
    FrontendConfig,
    default_frontend,
    global_mvn,
    utterance_mvn,
)
from llm_guided_asr_tpu_torch.search.greedy import ctc_greedy_decode
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import causal_attn_mask, make_valid_mask


@dataclasses.dataclass(frozen=True)
class LLMGuidedASRConfig:
    vocab_size: int  # = LLM vocab size
    llm: LlamaConfig
    prompt: PromptTemplate
    frontend: FrontendConfig = FrontendConfig()
    normalize: str = "global_mvn"  # global_mvn | utterance_mvn | none
    encoder_type: str = "conformer"
    encoder: ConformerConfig = ConformerConfig()
    decoder: TransformerDecoderConfig = TransformerDecoderConfig()
    ctc_weight: float = 0.3
    blank_id: int = 0

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
        n_feat = cfg.frontend.n_mels
        with torch.device(dev):
            self.encoder = make_encoder(cfg.encoder_type, cfg.encoder, n_feat, device=dev)
            self.ctc_head = nn.Linear(d, cfg.vocab_size)
            self.llm = LlamaModel(cfg.llm, dtype=llm_dtype, device=dev)
            self.embed = nn.Linear(cfg.llm.hidden_size, d)
            dec = cfg.decoder
            for i in range(dec.num_blocks):
                setattr(self, f"block_{i}", DecoderLayer(d, dec.attention_heads, dec.linear_units))
            # a bare flax nn.LayerNorm in the JAX model: epsilon 1e-6
            self.after_norm = nn.LayerNorm(d, eps=1e-6)
            self.output_layer = nn.Linear(d, cfg.vocab_size)
            if cfg.normalize == "global_mvn":
                self.register_buffer("mvn_mean", torch.zeros(n_feat))
                self.register_buffer("mvn_inv_std", torch.ones(n_feat))

    @property
    def decoders(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.decoder.num_blocks)]

    # ------------------------------------------------------------------
    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        """[B, S] waveform -> ([B, T', D] encoder output, [B] lengths)."""
        f = self.cfg.frontend
        feats, feats_lengths = default_frontend(
            speech, speech_lengths, fs=f.fs, n_fft=f.n_fft, win_length=f.win_length,
            hop_length=f.hop_length, n_mels=f.n_mels, fmin=f.fmin, fmax=f.fmax,
            htk=f.htk, center=f.center, window=f.window,
        )
        if self.cfg.normalize == "global_mvn":
            feats = global_mvn(feats, self.mvn_mean, self.mvn_inv_std, feats_lengths)
        elif self.cfg.normalize == "utterance_mvn":
            feats = utterance_mvn(feats, feats_lengths)
        return self.encoder(feats, feats_lengths)

    def ctc_log_softmax(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_head(encoder_out).float(), dim=-1)

    def _first_pass_hyp(self, encoder_out, encoder_out_lengths):
        """Greedy CTC hypothesis in LLM-vocab ids, over the valid frames only
        (the JAX model's default, first_pass_pad_frames=False)."""
        cfg = self.cfg
        return ctc_greedy_decode(
            self.ctc_log_softmax(encoder_out), encoder_out_lengths,
            blank_id=cfg.blank_id, pad_id=cfg.prompt.pad_id,
        )

    def _llm_response_states(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths):
        """First-pass CTC -> prompt pack -> frozen LLM -> response hidden states."""
        hyp, hyp_lengths = self._first_pass_hyp(encoder_out, encoder_out_lengths)
        ids, valid, resp_start = pack_prompt(self.cfg.prompt, hyp, hyp_lengths, ys_in, ys_in_lengths)
        hidden, _ = self.llm(ids, valid)
        resp = gather_response(hidden, resp_start, ys_in.shape[1]).float()
        resp_valid = make_valid_mask(ys_in_lengths, ys_in.shape[1])
        return resp.masked_fill(~resp_valid[..., None], 0.0)

    def decoder_logits(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths):
        """Full (uncached) guided decoder forward -> [B, L, V] logits."""
        x = self.embed(self._llm_response_states(
            encoder_out, encoder_out_lengths, ys_in, ys_in_lengths))
        tgt_mask = causal_attn_mask(ys_in_lengths, ys_in.shape[1])
        memory_mask = make_valid_mask(encoder_out_lengths, encoder_out.shape[1])[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, encoder_out, memory_mask)
        return self.output_layer(self.after_norm(x))

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
