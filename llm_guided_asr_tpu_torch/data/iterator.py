"""Epoch-seeded batch iterator factory (counterpart of
llm_guided_asr_tpu/data/iterator.py).

Rebuild of espnet2/iterators/sequence_iter_factory.py: deterministic
per-epoch shuffling of a fixed batch list (``np.random.default_rng(seed +
epoch)``, as the JAX package draws it, so both see the same batches in the
same order), optional num_iters_per_epoch windowing, per-rank sharding
(batches[rank::world_size], abs_task.py:1823), and the copy of each batch to
an explicit device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def to_device(batch: Dict, device: Union[str, torch.device]) -> Dict:
    """numpy arrays -> tensors on ``device``: integer arrays as int64 (torch
    indexes with int64), floating ones as float32, one non-blocking copy
    each; other values (``_uids``, ``_nvalid``) pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = v.astype(np.int64 if np.issubdtype(v.dtype, np.integer) else np.float32,
                         copy=False)
            out[k] = torch.from_numpy(v).to(device, non_blocking=True)
        else:
            out[k] = v
    return out


class SequenceIterFactory:
    """``factory(epoch)`` -> iterator over that epoch's collated batches,
    on ``device`` (None: numpy arrays as the collate made them)."""

    def __init__(
        self,
        dataset,
        batches: Sequence[Tuple[str, ...]],
        collate_fn,
        shuffle: bool = True,
        seed: int = 0,
        num_iters_per_epoch: Optional[int] = None,
        rank: int = 0,
        world_size: int = 1,
        device: Optional[Union[str, torch.device]] = "cuda",
    ):
        self.dataset = dataset
        self.batches = list(batches)
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_iters_per_epoch = num_iters_per_epoch
        self.rank = rank
        self.world_size = world_size
        self.device = device

    def __call__(self, epoch: int) -> Iterator[Dict]:
        return self.build_iter(epoch)

    def batch_order(self, epoch: int) -> list:
        """Indices into ``batches`` of this epoch, on this rank."""
        order = list(range(len(self.batches)))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(order)
        if self.num_iters_per_epoch is not None:
            # rotate deterministically so successive epochs cover all batches
            n = self.num_iters_per_epoch
            start = (epoch - 1) * n % max(len(order), 1)
            order = (order * (n // max(len(order), 1) + 2))[start : start + n]
        return order[self.rank :: self.world_size] if self.world_size > 1 else order

    def build_iter(self, epoch: int) -> Iterator[Dict]:
        for bi in self.batch_order(epoch):
            uids = self.batches[bi]
            batch = self.collate_fn([(u, self.dataset[u]) for u in uids])
            yield batch if self.device is None else to_device(batch, self.device)
