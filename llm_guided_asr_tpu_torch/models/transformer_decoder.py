"""Transformer decoder configuration (counterpart of llm_guided_asr_tpu/models/transformer_decoder.py).

Only the config is ported so far: the LLM-guided model builds its decoder
blocks from it.  The stand-alone TransformerDecoder comes with the phase-1
CTC/attention model.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TransformerDecoderConfig:
    """The fields of the JAX TransformerDecoderConfig that inference reads
    (dropout is off in eval mode; the blocks are pre-norm)."""

    attention_heads: int = 4
    linear_units: int = 2048
    num_blocks: int = 6
