"""Device selection for the entry points that create tensors, and the
kernels' dispatch rule.

Entry points (`scenarios`, `bridge`, `launch.serve`) run on the card by
default. A missing card is an error, never a silent move to the CPU: the
caller asks for the CPU explicitly with ``device="cpu"``, as the tests do.
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


def wants_kernel(use_kernel, x) -> bool:
    """The kernels' dispatch rule (the reference's ``use_pallas="auto"``):
    "auto" means the CUDA kernel iff ``x`` lies on a CUDA device; True on a
    CPU tensor raises; False asks for the plain version on any device."""
    on_cuda = torch.as_tensor(x).is_cuda
    if use_kernel == "auto":
        return on_cuda
    if use_kernel and not on_cuda:
        raise ValueError(
            "use_kernel=True needs CUDA tensors; CPU tensors take the plain "
            "version (use_kernel='auto' or False)"
        )
    return bool(use_kernel)
