"""LLM-guided ASR model (counterpart of llm_guided_asr_tpu/models/llm_guided.py).

waveform -> frontend -> Conformer -> greedy CTC first pass -> ((HYP)) prompt
-> frozen Llama -> response hidden states -> Linear(llm_hidden -> D)
("embed") -> 6-block guided decoder cross-attending to the encoder ->
logits over the LLM vocabulary.

``forward`` is the phase-2 training loss: the encoder stays in eval mode
whatever ``.train()`` says (the recipe freezes it), the LLM is frozen and
its hidden states carry no gradient, and the guided decoder's dropout
follows ``.train()``.  ``decode_prefix``/``decode_step`` are the cached
decoding pair the beam search calls, for B lanes (utterances) of K beams:
one LLM forward over the B prompts, whose KV each lane's beams share; each
step runs one Llama call and one guided-decoder pass over the B*K rows
(one new token, one position).

Options of the JAX model that are ported here:

- per-utterance biasing words, packed at the template's ``((BIAS))`` slot
  (``bias_words`` on ``decoder_logits``, ``forward`` and ``decode_prefix``);
- mixed-vocab CTC (``ctc_vocab_size``): the CTC head has its own
  vocabulary, and the first pass is expanded to LLM ids through the
  ``ctc_map_ids``/``ctc_map_lens`` buffers (models/llm/prompt.py
  ``expand_token_ids``); the loss then needs ``ctc_text``;
- ``llm_score_mode="log_softmax"``: a decoding step scores with the LLM's
  own next-token log-probs, bypassing the guided decoder.

:func:`build_llm_guided_model` builds the model from a task config whose
``llm_conf`` names a local checkpoint directory (config.json,
tokenizer.json, safetensors); :func:`load_llm_params` streams its weights
in.  Nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from llm_guided_asr_tpu_torch.models.asr_model import extract_features
from llm_guided_asr_tpu_torch.models.conformer import ConformerConfig, make_encoder
from llm_guided_asr_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel, stream_checkpoint
from llm_guided_asr_tpu_torch.models.llm.prompt import (
    PromptTemplate,
    build_ctc_to_llm_map,
    expand_token_ids,
    gather_response,
    pack_prompt,
    split_template,
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
from llm_guided_asr_tpu_torch.search.scorers import lane_rows
from llm_guided_asr_tpu_torch.text.tokenizers import LLMTokenizer
from llm_guided_asr_tpu_torch.utils.config import filter_known_fields, read_token_list
from llm_guided_asr_tpu_torch.utils.device import resolve_device
from llm_guided_asr_tpu_torch.utils.masks import causal_attn_mask, make_valid_mask
from llm_guided_asr_tpu_torch.utils.rng import StepRNG

logger = logging.getLogger(__name__)
SCORE_MODES = ("hidden", "log_softmax")


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
    # mixed-vocab CTC: the CTC head's own vocabulary, each token expanding
    # to at most ctc_map_width LLM ids
    ctc_vocab_size: Optional[int] = None
    ctc_map_width: int = 8
    # decoding scores: "hidden" (the guided decoder over the LLM's hidden
    # states) or "log_softmax" (the LLM's own next-token log-probs)
    llm_score_mode: str = "hidden"

    @property
    def n_feat(self) -> int:
        if self.frontend is not None:
            return self.frontend.n_mels
        if self.input_size is None:
            raise ValueError("a model without a frontend needs input_size")
        return self.input_size

    @property
    def ctc_dim(self) -> int:
        """The CTC head's outputs."""
        return self.ctc_vocab_size or self.vocab_size

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
        if cfg.llm_score_mode not in SCORE_MODES:
            raise ValueError(f"llm_score_mode={cfg.llm_score_mode!r}, not one of {SCORE_MODES}")
        dev = resolve_device(device)
        self.cfg = cfg
        d = cfg.encoder.output_size
        n_feat = cfg.n_feat
        ctc_dim = cfg.ctc_dim
        with torch.device(dev):
            self.encoder = make_encoder(cfg.encoder_type, cfg.encoder, n_feat, device=dev)
            self.ctc_head = nn.Linear(d, ctc_dim)
            if cfg.ctc_vocab_size:
                self.register_buffer("ctc_map_ids", torch.zeros((ctc_dim, cfg.ctc_map_width),
                                                                dtype=torch.int64))
                self.register_buffer("ctc_map_lens", torch.zeros(ctc_dim, dtype=torch.int64))
            self.llm = LlamaModel(cfg.llm, dtype=llm_dtype, device=dev,
                                  lm_head=cfg.llm_score_mode == "log_softmax")
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
        over every frame with ``first_pass_pad_frames``; a mixed-vocab
        hypothesis is expanded through the CTC map."""
        cfg = self.cfg
        if cfg.first_pass_pad_frames:
            encoder_out_lengths = torch.full_like(encoder_out_lengths, encoder_out.shape[1])
        hyp, hyp_lengths = ctc_greedy_decode(
            self.ctc_log_softmax(encoder_out), encoder_out_lengths,
            blank_id=cfg.blank_id, pad_id=cfg.prompt.pad_id,
        )
        if cfg.ctc_vocab_size:
            hyp, hyp_lengths = expand_token_ids(self.ctc_map_ids, self.ctc_map_lens, hyp,
                                                hyp_lengths, cfg.prompt.pad_id)
        return hyp, hyp_lengths

    def _pack(self, hyp, hyp_lengths, resp, resp_lengths, bias_words, bias_words_lengths):
        """pack_prompt with the bias words, one row of them shared by a batch."""
        if bias_words is not None and bias_words.shape[0] != hyp.shape[0]:
            bias_words = bias_words.expand(hyp.shape[0], -1)
            bias_words_lengths = bias_words_lengths.reshape(-1).expand(hyp.shape[0])
        return pack_prompt(self.cfg.prompt, hyp, hyp_lengths, resp, resp_lengths,
                           bias=bias_words, bias_lengths=bias_words_lengths)

    def _llm_response_states(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths,
                             bias_words=None, bias_words_lengths=None):
        """First-pass CTC -> prompt pack -> frozen LLM -> response hidden states."""
        hyp, hyp_lengths = self._first_pass_hyp(encoder_out, encoder_out_lengths)
        ids, valid, resp_start = self._pack(hyp, hyp_lengths, ys_in, ys_in_lengths, bias_words,
                                            bias_words_lengths)
        with torch.no_grad():  # the LLM is frozen: no backward graph through it
            hidden, _ = self.llm(ids, valid)
        resp = gather_response(hidden, resp_start, ys_in.shape[1]).float()
        resp_valid = make_valid_mask(ys_in_lengths, ys_in.shape[1])
        return resp.masked_fill(~resp_valid[..., None], 0.0)

    def decoder_logits(self, encoder_out, encoder_out_lengths, ys_in, ys_in_lengths,
                       rng: Optional[StepRNG] = None, bias_words=None, bias_words_lengths=None):
        """Full (uncached) guided decoder forward -> [B, L, V] logits."""
        x = self.embed(self._llm_response_states(
            encoder_out, encoder_out_lengths, ys_in, ys_in_lengths, bias_words,
            bias_words_lengths))
        tgt_mask = causal_attn_mask(ys_in_lengths, ys_in.shape[1])
        memory_mask = make_valid_mask(encoder_out_lengths, encoder_out.shape[1])[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, encoder_out, memory_mask, rng=rng)
        return self.output_layer(self.after_norm(x))

    def forward(self, speech: torch.Tensor, speech_lengths: torch.Tensor, text: torch.Tensor,
                text_lengths: torch.Tensor, rng: Optional[StepRNG] = None,
                bias_words: Optional[torch.Tensor] = None,
                bias_words_lengths: Optional[torch.Tensor] = None,
                ctc_text: Optional[torch.Tensor] = None,
                ctc_text_lengths: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """Phase-2 loss: text [B, L] (LLM-vocab ids padded with ignore_id)
        -> (loss, stats, weight), ctc_weight * CTC + (1 - ctc_weight) *
        label-smoothed CE of the guided decoder.  bias_words [B, W]: each
        utterance's biasing ids; ctc_text [B, Lc]: the CTC targets in the
        CTC vocabulary (a mixed-vocab model needs them)."""
        cfg = self.cfg
        enc_out, enc_lens = self.encode(speech, speech_lengths, rng)
        stats: Dict[str, torch.Tensor] = {}
        loss_ctc = torch.zeros((), dtype=torch.float32, device=enc_out.device)
        if cfg.ctc_weight > 0.0:
            if cfg.ctc_vocab_size and ctc_text is None:
                raise ValueError("a mixed-vocab model needs ctc_text (CTC-vocab targets); the "
                                 "LLM-vocab text ids exceed the CTC head")
            tgt, tgt_lens = (text, text_lengths) if ctc_text is None else (ctc_text,
                                                                          ctc_text_lengths)
            loss_ctc = ctc_loss(self.ctc_head(enc_out), enc_lens, tgt, tgt_lens, cfg.blank_id)
            stats["loss_ctc"] = loss_ctc
        ys_in, ys_out = add_sos_eos(text, text_lengths, cfg.sos_id, cfg.eos_id, cfg.ignore_id)
        dec_logits = self.decoder_logits(enc_out, enc_lens, ys_in, text_lengths + 1, rng,
                                         bias_words, bias_words_lengths)
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
    def decode_prefix(self, encoder_out, encoder_out_lengths, beam: int, resp_max: int,
                      bias_words=None, bias_words_lengths=None) -> Dict:
        """First pass + one prompt-only LLM forward over the B lanes; build
        the decoding state of their B*K rows (lane-major).

        Each lane's prompt KV is copied into its beams' float32 buffers of
        prompt_len + resp_max positions (float32 even for a bfloat16 LLM, as
        in the JAX model).  The guided decoder's memory K/V projections are
        utterance-constant and computed here once per lane.
        """
        cfg = self.cfg
        hyp, hyp_lengths = self._first_pass_hyp(encoder_out, encoder_out_lengths)
        b, dev = encoder_out.shape[0], encoder_out.device
        empty = torch.zeros((b, 0), dtype=torch.int64, device=dev)
        ids, valid, _ = self._pack(hyp, hyp_lengths, empty,
                                   torch.zeros((b,), dtype=torch.int64, device=dev),
                                   bias_words, bias_words_lengths)
        _, cache = self.llm(ids, valid)
        tp = ids.shape[1]
        tc = tp + resp_max
        hkv, hd = cfg.llm.num_key_value_heads, cfg.llm.head_dim
        k_bufs, v_bufs = [], []
        for k, v in cache:
            kb = torch.zeros((b * beam, tc, hkv, hd), dtype=torch.float32, device=dev)
            vb = torch.zeros((b * beam, tc, hkv, hd), dtype=torch.float32, device=dev)
            kb.view(b, beam, tc, hkv, hd)[:, :, :tp] = k[:, None].float()
            vb.view(b, beam, tc, hkv, hd)[:, :, :tp] = v[:, None].float()
            k_bufs.append(kb)
            v_bufs.append(vb)
        kv_valid = torch.zeros((b * beam, tc), dtype=torch.bool, device=dev)
        kv_valid.view(b, beam, tc)[:, :, :tp] = valid[:, None]
        gd_mem = [layer.project_mem_kv(encoder_out) for layer in self.decoders]
        return {
            "k": k_bufs,
            "v": v_bufs,
            "kv_valid": kv_valid,
            "prompt_nvalid": valid.sum(dim=1),  # [B]
            "prompt_len": tp,
            "gd_mem_k": torch.stack([m[0] for m in gd_mem]),  # [L, B, T, H, dk]
            "gd_mem_v": torch.stack([m[1] for m in gd_mem]),
            "gd_xs": torch.zeros((len(gd_mem), b * beam, resp_max, encoder_out.shape[2]),
                                 dtype=torch.float32, device=dev),
        }

    def decode_step(
        self,
        encoder_out: torch.Tensor,  # [B, T, D]
        encoder_out_lengths: torch.Tensor,  # [B]
        state: Dict,
        last_token: torch.Tensor,  # [B*K] most recent response token (sos at step 0)
        step: int,  # response position
    ) -> Tuple[torch.Tensor, Dict]:
        """One cached step over the B*K rows: the LLM on the new token only
        (row positions: its lane's prompt length + step), then one position
        through the guided decoder against the row's lane -> log-probs
        [B*K, V].  In ``log_softmax`` mode the LLM's own next-token
        log-probs are the scores and the guided decoder does not run.

        Updates the state IN PLACE: the new token's LLM k/v go into the KV
        buffers at prompt_len + step (the JAX model writes the same values
        with dynamic_update_slice), its decoder inputs into gd_xs.
        """
        rows = state["k"][0].shape[0]
        b = encoder_out.shape[0]
        beam = rows // b
        resp_max = state["gd_xs"].shape[2]
        write = state["prompt_len"] + step
        dev = encoder_out.device
        positions = lane_rows((state["prompt_nvalid"] + step)[:, None], beam)
        use_lm_logits = self.cfg.llm_score_mode == "log_softmax"
        out = self.llm(
            last_token[:, None],
            torch.ones((rows, 1), dtype=torch.bool, device=dev),
            cache=list(zip(state["k"], state["v"])),
            cache_valid=state["kv_valid"],
            positions=positions,
            cache_write_pos=write,
            return_logits=use_lm_logits,
        )
        state["kv_valid"][:, write] = True
        if use_lm_logits:
            return F.log_softmax(out[1][:, -1].float(), dim=-1), state

        x_cur = self.embed(out[0].float())  # [B*K, 1, D]
        tgt_mask = (torch.arange(resp_max, device=dev) <= step)[None, None, :].expand(rows, 1, resp_max)
        t_enc = encoder_out.shape[1]
        mem = lane_rows(encoder_out, beam)
        mem_valid = torch.arange(t_enc, device=dev)[None, :] < encoder_out_lengths[:, None]
        mem_mask = lane_rows(mem_valid[:, None, :], beam)  # [B*K, 1, T]
        gd_xs = state["gd_xs"]
        for i, layer in enumerate(self.decoders):
            gd_xs[i, :, step] = x_cur[:, 0]
            mem_kv = (lane_rows(state["gd_mem_k"][i], beam), lane_rows(state["gd_mem_v"][i], beam))
            x_cur = layer(x_cur, tgt_mask, mem, mem_mask, self_kv=gd_xs[i], mem_kv=mem_kv)
        logits = self.output_layer(self.after_norm(x_cur))[:, 0]
        return F.log_softmax(logits.float(), dim=-1), state

    def load_llm_state(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load the frozen LLM's weights (the port's names, as
        :func:`load_llm_params` returns them); an untied ``lm_head`` is
        dropped when the model scores with hidden states and holds none."""
        if not hasattr(self.llm, "lm_head"):
            state_dict = {k: v for k, v in state_dict.items() if k != "lm_head.weight"}
        self.llm.load_state_dict(state_dict)


# ---------------------------------------------------------------------------
# building from a task config (tasks/asr.py:638-680 of the JAX package)
# ---------------------------------------------------------------------------

_LLM_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.bfloat16, "float32": torch.float32}


def llm_dtype(llm_conf: Dict[str, Any]) -> torch.dtype:
    return _LLM_DTYPES[llm_conf.get("dtype", "float32")]


def _conf(config: Dict[str, Any], key: str) -> Dict[str, Any]:
    return dict(config.get(key, {}) or {})


def guided_fields(config: Dict[str, Any]) -> Dict[str, Any]:
    """The config fields that the guided ASR and ST models share, read from
    a task config: frontend, SpecAug, normalization, encoder, guided
    decoder and ``input_size``."""
    frontend = None
    if config.get("frontend", "default") not in (None, "none") and config.get("input_size") is None:
        fe = filter_known_fields(FrontendConfig, _conf(config, "frontend_conf"), "frontend_conf")
        if fe.get("fmin") is None:
            fe["fmin"] = 0.0
        frontend = FrontendConfig(**fe)
    specaug = None
    if config.get("specaug") == "specaug":
        sa = _conf(config, "specaug_conf")
        sa.pop("time_warp_mode", None)  # interpolation mode: always linear
        for k in ("freq_mask_width_range", "time_mask_width_range", "time_mask_width_ratio_range"):
            if sa.get(k) is not None:
                sa[k] = tuple(sa[k])
        specaug = SpecAugConfig(**sa)
    return dict(
        frontend=frontend,
        specaug=specaug,
        normalize=config.get("normalize") or "none",
        encoder_type=config.get("encoder", "conformer"),
        encoder=ConformerConfig(**filter_known_fields(
            ConformerConfig, _conf(config, "encoder_conf"), "encoder_conf")),
        decoder=TransformerDecoderConfig(**filter_known_fields(
            TransformerDecoderConfig, _conf(config, "decoder_conf"), "decoder_conf")),
        input_size=config.get("input_size"),
    )


def build_llm_guided_model(config: Dict[str, Any],
                           device: Union[str, torch.device] = "cuda") -> LLMGuidedASRModel:
    """The model of a task config.  ``llm_conf.model_name_or_path`` names a
    local checkpoint directory (its config.json and tokenizer.json give the
    LLM's size and the prompt template); the LLM's weights are loaded
    separately by :func:`load_llm_params` (frozen weights live in no
    checkpoint).  With a ``ctc_token_list`` the CTC head has that
    vocabulary and the CTC map buffers are filled here."""
    llm_conf = _conf(config, "llm_conf")
    spec = resolve_llm_spec(llm_conf)
    model_conf = _conf(config, "model_conf")
    cfg = LLMGuidedASRConfig(
        vocab_size=spec["llm_config"].vocab_size,
        llm=spec["llm_config"],
        prompt=spec["template"],
        ctc_weight=float(model_conf.get("ctc_weight", 0.3)),
        lsm_weight=float(model_conf.get("lsm_weight", 0.0)),
        length_normalized_loss=bool(model_conf.get("length_normalized_loss", False)),
        ctc_vocab_size=(len(read_token_list(config["ctc_token_list"]))
                        if config.get("ctc_token_list") else None),
        ctc_map_width=int(model_conf.get("ctc_map_width", 8)),
        llm_score_mode=str(model_conf.get("llm_score_mode", "hidden")),
        **guided_fields(config),
    )
    model = LLMGuidedASRModel(cfg, llm_dtype=llm_dtype(llm_conf), device=device)
    if cfg.ctc_vocab_size:
        table = build_ctc_map_variables(config)
        with torch.no_grad():
            model.ctc_map_ids.copy_(table["ids"])
            model.ctc_map_lens.copy_(table["lens"])
    return model


def build_ctc_map_variables(config: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The CTC-vocab -> LLM-ids table of a mixed-vocab config:
    ``{"ids": [Vc, ctc_map_width], "lens": [Vc]}`` (int64, on the CPU)."""
    tokens = read_token_list(config["ctc_token_list"])
    spec = resolve_llm_spec(_conf(config, "llm_conf"))
    width = int(_conf(config, "model_conf").get("ctc_map_width", 8))
    ids, lens = build_ctc_to_llm_map(tokens, spec["tokenizer"], max_expand=width)
    return {"ids": torch.from_numpy(ids).long(), "lens": torch.from_numpy(lens).long()}


_LLM_SPEC_CACHE: Dict[str, Dict] = {}


def resolve_llm_spec(llm_conf: Dict[str, Any]) -> Dict:
    """The configured LLM's config, tokenizer and prompt template, read from
    its local directory (cached by name and template)."""
    name = str(llm_conf["model_name_or_path"])
    cache_key = f"{name}::{llm_conf.get('template_prompt')}::{llm_conf.get('pad_token')}"
    if cache_key in _LLM_SPEC_CACHE:
        return _LLM_SPEC_CACHE[cache_key]
    local = _resolve_checkpoint_dir(name, llm_conf.get("cache_dir"))
    if local is None:
        raise FileNotFoundError(
            f"LLM {name!r} is not a local checkpoint directory (nor a snapshot under "
            f"cache_dir={llm_conf.get('cache_dir')!r}); nothing is downloaded")
    hf = json.loads((local / "config.json").read_text())
    tokenizer = LLMTokenizer.from_pretrained(local)
    bos, eos = hf.get("bos_token_id"), hf.get("eos_token_id")
    if isinstance(eos, (list, tuple)):
        eos = eos[0]  # llama3 lists several eos tokens
    if bos is None:
        bos = tokenizer.bos_token_id if tokenizer.bos_token_id is not None else 0
    template = split_template(tokenizer, llm_conf.get("template_prompt"), bos_token_id=bos,
                              eos_token_id=eos if eos is not None else 0,
                              pad_token=llm_conf.get("pad_token"))
    spec = {"llm_config": LlamaConfig.from_hf_config(hf), "template": template,
            "tokenizer": tokenizer, "name": name, "path": local}
    _LLM_SPEC_CACHE[cache_key] = spec
    return spec


def load_llm_params(config: Dict[str, Any], model: Optional[LLMGuidedASRModel] = None,
                    device: Union[str, torch.device, None] = None) -> Dict[str, torch.Tensor]:
    """The frozen LLM's weights from its local directory (``model.safetensors``
    or the shards of ``model.safetensors.index.json``), streamed tensor by
    tensor, each cast to the LLM dtype of ``llm_conf.dtype`` and moved to
    the device before the next is read.  With ``model`` they are loaded into
    it (on its device) as well.  Returns the LLM state dict."""
    llm_conf = _conf(config, "llm_conf")
    spec = resolve_llm_spec(llm_conf)
    if device is None:
        device = next(model.parameters()).device if model is not None else "cuda"
    params = stream_checkpoint(spec["path"], spec["llm_config"], dtype=llm_dtype(llm_conf),
                               device=resolve_device(device))
    logger.info(f"streamed frozen LLM weights from {spec['path']}")
    if model is not None:
        model.load_llm_state(params)
    return params


def _resolve_checkpoint_dir(name: str, cache_dir=None) -> Optional[Path]:
    """A local directory holding the LLM's config.json: ``name`` itself, or
    the newest snapshot of a Hugging Face hub cache under ``cache_dir``
    (<cache>/models--org--name/snapshots/<rev>/).  Never downloads."""
    cand = Path(name)
    if cand.is_dir():
        return cand if (cand / "config.json").is_file() else None
    if cache_dir:
        base = Path(cache_dir) / ("models--" + name.replace("/", "--")) / "snapshots"
        if base.is_dir():
            for snap in sorted(base.iterdir(), reverse=True):
                if (snap / "config.json").is_file():
                    return snap
    return None
