"""Random streams of a training step, and dropout.

The JAX package threads explicit PRNG keys (``rngs={"dropout": ...,
"specaug": ...}``); the port threads one :class:`StepRNG` through the
forward calls instead.  Its ``device`` generator draws the dropout masks
and SpecAug's values on the model's device; its ``host`` generator, on the
CPU, draws the int32 seeds of the attention kernel's dropout hash, so a
seed needs no copy from the device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn


class StepRNG:
    """One step's generators, seeded from the CPU generator ``host``."""

    def __init__(self, host: torch.Generator, device: Union[str, torch.device] = "cpu"):
        dev = torch.device(device)
        self.host = host
        if dev.type == "cpu":
            self.device = host
        else:
            seed = int(torch.randint(0, 2**62, (1,), generator=host))
            self.device = torch.Generator(device=dev).manual_seed(seed)

    def seed32(self) -> int:
        """A fresh int32 seed for the attention kernel's dropout hash."""
        return int(torch.randint(-2**31, 2**31, (1,), generator=self.host))


def active_rate(module: nn.Module, rate: float) -> float:
    """A module's dropout rate as it applies now: 0 in eval mode."""
    return rate if module.training else 0.0


def dropout(x: torch.Tensor, rate: float, rng: Optional[StepRNG]) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``rng.device``; the
    identity when ``rate`` is 0 (callers pass 0 in eval mode)."""
    if rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in training mode needs a StepRNG")
    keep = torch.rand(x.shape, generator=rng.device, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
