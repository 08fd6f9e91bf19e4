"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``.  The CPU is used only when the
caller asks for it (the tests do); a CUDA request without a card raises
instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Validate ``device`` and fix the card's float32 precision.

    On the card, float32 matmuls and convolutions run in full float32:
    TF32 is switched off for both cuBLAS and cuDNN (cuDNN defaults to it),
    so the port computes what the f32 reference computes.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but no CUDA device is available; "
                "pass device='cpu' explicitly to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
