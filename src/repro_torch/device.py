"""Device selection for the entry points that create tensors.

Entry points (`scenarios`, `bridge`) run on the card by default. A missing
card is an error, never a silent move to the CPU: the caller asks for the
CPU explicitly with ``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
