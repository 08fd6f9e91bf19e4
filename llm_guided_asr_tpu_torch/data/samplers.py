"""Batch samplers: unsorted / sorted / folded / numel (the port's own copy of
llm_guided_asr_tpu/data/samplers.py).

Rebuild of espnet2/samplers/ (build_batch_sampler.py:12-71 BATCH_TYPES,
num_elements_batch_sampler.py, sorted_batch_sampler.py,
folded_batch_sampler.py, unsorted_batch_sampler.py).

All samplers return a list of utterance-id tuples; the distributed shard is
taken per host as ``batches[rank::world_size]`` with
min_batch_size >= world_size, exactly like abs_task.py:1791-1823.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _lengths_from_shape_file(shape: Dict[str, Tuple[int, ...]]) -> Dict[str, int]:
    return {k: v[0] for k, v in shape.items()}


def unsorted_batch_sampler(keys: Sequence[str], batch_size: int) -> List[Tuple[str, ...]]:
    return [tuple(keys[i : i + batch_size]) for i in range(0, len(keys), batch_size)]


def sorted_batch_sampler(
    keys: Sequence[str],
    lengths: Dict[str, int],
    batch_size: int,
    sort_in_batch: str = "descending",
) -> List[Tuple[str, ...]]:
    order = sorted(keys, key=lambda k: lengths[k], reverse=(sort_in_batch == "descending"))
    return [tuple(order[i : i + batch_size]) for i in range(0, len(order), batch_size)]


def folded_batch_sampler(
    keys: Sequence[str],
    lengths: Dict[str, int],
    batch_size: int,
    fold_length: int,
    min_batch_size: int = 1,
) -> List[Tuple[str, ...]]:
    """Shrink batch size for long utterances (folded_batch_sampler.py)."""
    order = sorted(keys, key=lambda k: lengths[k], reverse=True)
    batches = []
    i = 0
    while i < len(order):
        L = lengths[order[i]]
        bs = max(min_batch_size, int(batch_size / max(1, np.ceil(L / fold_length))))
        batches.append(tuple(order[i : i + bs]))
        i += bs
    return batches


def num_elements_batch_sampler(
    keys: Sequence[str],
    lengths: Dict[str, int],
    batch_bins: int,
    min_batch_size: int = 1,
    sort_in_batch: str = "descending",
    feat_dim: int = 1,
) -> List[Tuple[str, ...]]:
    """batch_type=numel: cap padded-tensor elements per batch
    (num_elements_batch_sampler.py, the recipe default).

    bins(batch) = len(batch) * maxlen(batch) * feat_dim <= batch_bins.
    """
    order = sorted(keys, key=lambda k: lengths[k], reverse=(sort_in_batch == "descending"))
    batches: List[Tuple[str, ...]] = []
    cur: List[str] = []
    cur_max = 0
    for k in order:
        cand_max = max(cur_max, lengths[k])
        if cur and (len(cur) + 1) * cand_max * feat_dim > batch_bins and len(cur) >= min_batch_size:
            batches.append(tuple(cur))
            cur, cur_max = [k], lengths[k]
        else:
            cur.append(k)
            cur_max = cand_max
    if cur:
        batches.append(tuple(cur))
    return batches


def round_batches_to_world_size(
    batches: List[Tuple[str, ...]], world_size: int
) -> List[Tuple[str, ...]]:
    """Re-chunk batches so every batch size is divisible by the data-axis
    size, without repeating any utterance.

    The reference enforces divisibility at the sampler (abs_task.py:1817-1823
    ``--batch_size must be >= world_size``); here a global batch is sharded
    by rows over the mesh 'data' axis, so non-divisible batches would hit the
    JAX trainer's repeat-padding safety net (shard_batch_padded)
    and silently upweight the repeated rows.  This pass slides utterances
    across neighboring batches (preserving the sampler's length-sorted
    locality) and drops only the final ``len(keys) % world_size`` tail —
    torch DistributedSampler(drop_last=True) semantics.  Tiny-corpus guard:
    if everything would be dropped, the original batches are returned and the
    safety net handles them.
    """
    if world_size <= 1:
        return batches
    keys = [k for b in batches for k in b]
    if len(keys) < world_size:
        return batches
    out: List[Tuple[str, ...]] = []
    prev = 0
    cum = 0
    for b in batches:
        cum += len(b)
        edge = (cum // world_size) * world_size
        if edge > prev:
            out.append(tuple(keys[prev:edge]))
            prev = edge
    return out


BATCH_TYPES = {
    "unsorted": "batch_size utterances per batch, dataset order",
    "sorted": "batch_size utterances per batch, sorted by length",
    "folded": "batch size shrinks with length / fold_length",
    "numel": "bounded padded-element count per batch (batch_bins)",
}


def build_batch_sampler(
    batch_type: str,
    keys: Sequence[str],
    lengths: Optional[Dict[str, int]] = None,
    batch_size: int = 16,
    batch_bins: int = 1000000,
    fold_length: int = 80000,
    min_batch_size: int = 1,
    sort_in_batch: str = "descending",
    feat_dim: int = 1,
) -> List[Tuple[str, ...]]:
    if batch_type == "unsorted":
        return unsorted_batch_sampler(keys, batch_size)
    if lengths is None:
        raise ValueError(f"batch_type={batch_type} requires utterance lengths")
    if batch_type == "sorted":
        return sorted_batch_sampler(keys, lengths, batch_size, sort_in_batch)
    if batch_type == "folded":
        return folded_batch_sampler(keys, lengths, batch_size, fold_length, min_batch_size)
    if batch_type == "numel":
        return num_elements_batch_sampler(
            keys, lengths, batch_bins, min_batch_size, sort_in_batch, feat_dim
        )
    raise ValueError(f"unknown batch_type {batch_type!r}; known: {sorted(BATCH_TYPES)}")
