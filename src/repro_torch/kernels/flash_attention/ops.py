"""Public flash-attention op, with dispatch.

Counterpart of `repro.kernels.flash_attention.ops`. It takes the model's
layout, q (B, S, H, hd) and k/v (B, S, KV, hd). ``use_kernel="auto"`` (the
reference's ``use_pallas="auto"``) means: the CUDA kernel iff the tensors lie
on a CUDA device, the chunked plain version
(`repro_torch.models.attention.flash_attention`) for CPU tensors.
``use_kernel=True`` on CPU tensors raises; ``use_kernel=False`` asks for the
plain version on any device, at the chunk sizes the caller gives (the
model passes its config's). A kernel that fails raises; nothing falls back.
The kernel reads the layout by stride and masks the ragged end of S itself,
so nothing is padded or transposed here.
"""
from __future__ import annotations

import torch

from repro_torch.device import wants_kernel

from . import kernel


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    use_kernel: str | bool = "auto", q_chunk=512, kv_chunk=1024):
    """Attention (B, S, H, hd) of q over k/v at positions 0..S-1."""
    if wants_kernel(use_kernel, q):
        return kernel.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    from repro_torch.models.attention import flash_attention as plain_flash

    pos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    return plain_flash(q, k, v, q_positions=pos, kv_positions=pos,
                       causal=causal, window=window, cap=cap,
                       q_chunk=q_chunk, kv_chunk=kv_chunk)
