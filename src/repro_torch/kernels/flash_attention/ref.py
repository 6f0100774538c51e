"""Naive O(S^2) attention oracle (independent of the chunked plain version).

Counterpart of `repro.kernels.flash_attention.ref`.
"""
from __future__ import annotations

import torch


def naive_attention(q, k, v, *, causal=True, window=None, cap=None):
    """q: (B,S,H,hd); k/v: (B,S,KV,hd). Returns (B,S,H,hd) in v's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / torch.sqrt(
        torch.tensor(float(hd), device=q.device)
    )
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, S, H, hd).to(v.dtype)
