"""The selective scan, one time step after another: the CUDA kernel's plain
version.

Counterpart of `repro.kernels.mamba_scan.ref` (a sequential ``lax.scan``
there, a Python loop over time here), in the same operations and order:

    da  = exp(dt_t A)
    h  <- da h + (dt_t x_t) B_t
    y_t = sum_n h C_t + D x_t

Only the state h (B, d_inner, N) is carried from step to step: the
(B, S, d_inner, N) tensor of every step's state, 4.3 GB a layer at Jamba's
width and S = 4096, is never built.
"""
from __future__ import annotations

import torch


def mamba_scan(x, dt, Bm, Cm, A, D, h0=None):
    """x, dt: (B, S, di); Bm, Cm: (B, S, N); A: (di, N); D: (di,); h0:
    (B, di, N) or None for zeros. Returns (y (B, S, di) in x's type, and the
    final state h, float32).

    The math is float32: every input is cast to it (exact for bfloat16).
    """
    B, S, di = x.shape
    N = Bm.shape[-1]
    if h0 is None:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    h = h0.float()
    Af, Df = A.float(), D.float()
    ys = []
    for t in range(S):
        x_t, dt_t, B_t, C_t = (v[:, t].float() for v in (x, dt, Bm, Cm))
        da = torch.exp(dt_t[..., None] * Af)                        # (B, di, N)
        h = da * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_t) + Df * x_t)
    if not ys:
        return torch.empty((B, 0, di), dtype=x.dtype, device=x.device), h
    return torch.stack(ys, dim=1).to(x.dtype), h
