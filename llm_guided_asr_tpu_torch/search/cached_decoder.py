"""KV-cached scoring for the standard transformer decoder (counterpart of llm_guided_asr_tpu/search/cached_decoder.py).

The stateless scorer recomputes the whole prefix through the decoder at
every beam step; this scorer keeps per-layer self-attention K/V buffers per
hypothesis row, written at each row's position, and computes the memory
(cross-attention) K/V once per utterance.  It reads the ``ASRModel``
decoder's own weights, so the cached and the full-recompute paths share
them.  As the JAX functions do, it takes every LayerNorm at epsilon 1e-6
(the decoder module itself runs at 1e-5), adds the sinusoidal position of
each row's token, and always applies ``after_norm`` and ``output_layer``.
Like the JAX functions, which multiply by the float32 parameters as they
are, it computes in the parameters' type: a bfloat16 model's memory is
promoted to it.

The scorer protocol is that of search/scorers.py: B lanes of K rows,
lane-major.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from llm_guided_asr_tpu_torch.models.transformer import sinusoidal_pos_enc

LN_EPS = 1e-6  # the JAX scorer's _ln


def _ln(norm, x):
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


class CachedDecoderScorer:
    """init/step/select scorer with per-layer self-attention KV buffers."""

    def __init__(self, model, num_heads: int, num_blocks: int):
        cfg = model.cfg.decoder
        kind = getattr(model.cfg, "decoder_type", "transformer")
        if kind != "transformer":
            # the JAX scorer indexes the decoder's params by block_{i}/src_attn,
            # which the other decoders lack: a KeyError at its first decode
            raise ValueError(f"the cached decoder serves the transformer decoder only, not "
                             f"decoder_type={kind!r}; use the stateless scorer "
                             f"(use_cached_decoder false)")
        if cfg.tie_input_output:
            # the JAX scorer reads an output_layer that a tied decoder lacks
            raise ValueError("the cached decoder does not serve tie_input_output; "
                             "use the stateless scorer (use_cached_decoder false)")
        if not (cfg.normalize_before and cfg.use_output_layer):
            raise NotImplementedError("the cached decoder needs normalize_before and an output layer")
        self.decoder = model.decoder
        self.h = num_heads
        self.n_blocks = num_blocks

    def _blocks(self):
        return [getattr(self.decoder, f"block_{i}") for i in range(self.n_blocks)]

    def init(self, enc, enc_lens, beam: int, lmax: int, ctx=None) -> Dict:
        """Memory K/V of each lane per layer [L, B, T, H, dk]; empty
        self-attention buffers [L, B*K, lmax, H, dk]."""
        enc = enc.to(torch.promote_types(enc.dtype, self.decoder.embed.weight.dtype))
        b, t, d = enc.shape
        dk = d // self.h
        mem_k, mem_v = [], []
        for blk in self._blocks():
            mem_k.append(blk.src_attn.linear_k(enc).reshape(b, t, self.h, dk))
            mem_v.append(blk.src_attn.linear_v(enc).reshape(b, t, self.h, dk))
        zeros = torch.zeros((self.n_blocks, b * beam, lmax, self.h, dk), dtype=enc.dtype,
                            device=enc.device)
        return {
            "mem_k": torch.stack(mem_k),
            "mem_v": torch.stack(mem_v),
            "self_k": zeros,
            "self_v": zeros.clone(),
            "mem_valid": torch.arange(t, device=enc.device)[None, :] < enc_lens.reshape(-1, 1),
        }

    def step(self, enc, enc_lens, state, tokens, lens, step: int):
        """One position per row through the blocks; the new K/V are written
        into the buffers at the row's position, in place."""
        rows = tokens.shape[0]
        b, t, d = enc.shape
        beam, h, dk = rows // b, self.h, d // self.h
        lmax = state["self_k"].shape[2]
        idx = torch.arange(rows, device=tokens.device)
        pos = lens - 1
        pe = torch.from_numpy(sinusoidal_pos_enc(lmax, d)).to(enc.device)
        x = self.decoder.embed.weight[tokens[idx, pos]] * math.sqrt(d) + pe[pos]  # [rows, D]
        kv_mask = torch.arange(lmax, device=enc.device)[None, :] <= pos[:, None]  # [rows, lmax]
        mem_mask = state["mem_valid"][:, None, None, :]  # [B, 1, 1, T]
        self_k, self_v = state["self_k"], state["self_v"]
        for i, blk in enumerate(self._blocks()):
            sa, ca, ff = blk.self_attn, blk.src_attn, blk.feed_forward
            hq = _ln(blk.norm1, x)
            q = sa.linear_q(hq).reshape(rows, h, dk)
            self_k[i, idx, pos] = sa.linear_k(hq).reshape(rows, h, dk)
            self_v[i, idx, pos] = sa.linear_v(hq).reshape(rows, h, dk)
            scores = torch.einsum("khd,klhd->khl", q, self_k[i]) / math.sqrt(dk)
            scores = scores.masked_fill(~kv_mask[:, None, :], -1e9)
            attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
            o = torch.einsum("khl,klhd->khd", attn, self_v[i]).reshape(rows, d)
            x = x + sa.linear_out(o)

            # cross-attention: each lane's K rows against its memory K/V
            q = ca.linear_q(_ln(blk.norm2, x)).reshape(b, beam, h, dk)
            scores = torch.einsum("bkhd,bthd->bkht", q, state["mem_k"][i]) / math.sqrt(dk)
            scores = scores.masked_fill(~mem_mask, -1e9)
            attn = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
            o = torch.einsum("bkht,bthd->bkhd", attn, state["mem_v"][i]).reshape(rows, d)
            x = x + ca.linear_out(o)

            x = x + ff.w_2(torch.relu(ff.w_1(_ln(blk.norm3, x))))
        logits = self.decoder.output_layer(_ln(self.decoder.after_norm, x))
        return torch.log_softmax(logits.float(), dim=-1), state

    def select(self, state: Dict, rows: torch.Tensor) -> Dict:
        return {**state, "self_k": state["self_k"].index_select(1, rows),
                "self_v": state["self_v"].index_select(1, rows)}
