"""The WKV6 recurrence, one time step after another: the CUDA kernel's plain
version.

Counterpart of `repro.kernels.rwkv6_scan.ref` (a sequential ``lax.scan``
there, a Python loop over time here), in the same operations and order:

    kv = k_t^T v_t
    y_t = r_t (S + diag(u) kv)
    S  <- diag(w_t) S + kv
"""
from __future__ import annotations

import torch


def rwkv6_scan(r, k, v, w, u, state=None, out_dtype=None):
    """r/k/v/w: (B, H, S, hd); u: (H, hd); state: (B, H, hd, hd) float32 or
    None for zeros. Returns (y (B, H, S, hd) in ``out_dtype``, r's type if
    None, and the final state).

    The math is float32: every input is cast to it; w is the per-step decay
    in (0, 1) (already exp(-exp(.))-transformed).
    """
    out_dtype = r.dtype if out_dtype is None else out_dtype
    B, H, S, hd = r.shape
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    state = state.float()
    uf = u.float()[..., :, None]                        # (H, hd, 1)
    ys = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (x[:, :, t].float() for x in (r, k, v, w))   # (B, H, hd)
        kv = k_t[..., :, None] * v_t[..., None, :]      # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, state + uf * kv))
        state = w_t[..., :, None] * state + kv
    if not ys:
        return torch.empty_like(r, dtype=out_dtype), state
    return torch.stack(ys, dim=2).to(out_dtype), state
