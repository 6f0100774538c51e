"""Plain float32 building blocks of the configurations' references (no
kernel, no cache, nothing of the program), and the control's fp8 products.

The references compute in float32 with TF32 off (`exact_float32`): on the
card a float32 product may otherwise run in TF32. The control puts the
nearest precision below the configurations' bf16 in the program's place:
every matrix product's two operands rounded to fp8 e4m3, each row of the
activations and each output column of the weight scaled to e4m3's largest
finite value first (as an fp8 GEMM with per-token and per-channel scales
takes them), the sum in float32.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32 (TF32 off), restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to e4m3 with one scale per slice along
    ``dim``'s complement: the slice's largest magnitude maps to 448."""
    scale = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), 1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """x (..., n) @ w (n, m) in float32; with ``fp8`` the control's product."""
    w = w.float()
    if fp8:
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + gamma) over the last axis (the program's RMSNorm)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + gamma.float())


def shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's features, zeros before the first: (S, d)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def matrix(fan_in: int, shape, matmul: bool = True) -> dict:
    """A tree-spec leaf of a product's weight: N(0, 1 / fan_in)."""
    return {"shape": list(shape), "std": fan_in ** -0.5, "matmul": matmul}


def vector(shape, mean: float = 0.0, std: float = 1.0) -> dict:
    """A tree-spec leaf drawn as mean + std N(0, 1)."""
    return {"shape": list(shape), "mean": mean, "std": std}
