"""Shared layer primitives: norms, RoPE, inits, FFNs.

Counterpart of `repro.models.layers`, in the same operation order and
precision (fp32 statistics and rotations, the result cast back), so that
float32 parity with the reference holds to round-off.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


#: the most entries `dense_init` draws at once into a destination: a larger
#: leaf (an expert stack) is drawn a run of first-axis slices at a time, so
#: its float32 temporaries stay near 1 GiB
DRAW_CHUNK = 2**28


class ShapesOnly:
    """Stands in for a `torch.Generator` in init's shape pass: every init
    function then makes its leaves on the meta device, and nothing is drawn
    (`models.model.init_params` sizes the stacked tree from it)."""

    device = torch.device("meta")


def dense_init(generator, shape, scale=None, dtype=torch.float32, out=None):
    """Standard normal * scale (default 1/sqrt(fan_in), fan_in = shape[0],
    which for a 3-D expert stack is the expert count, as in the reference),
    drawn in float32 on the generator's device, then cast: the reference's
    law, not its draws. With ``out`` (the leaf's slot in a stacked tree, of
    ``shape`` and ``dtype``) the draw is written into it and ``out`` is
    returned; a leaf of more than `DRAW_CHUNK` entries is drawn a run of
    first-axis slices at a time."""
    shape = tuple(shape)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / float(fan_in) ** 0.5
    dev = generator.device
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    draw = lambda s: torch.randn(s, generator=generator, device=dev, dtype=torch.float32) * scale
    if out is None:
        return draw(shape).to(dtype)
    if tuple(out.shape) != shape or out.dtype != dtype:
        raise ValueError(f"dense_init: out is {tuple(out.shape)} {out.dtype}, want {shape} {dtype}")
    step = max(1, DRAW_CHUNK // max(1, math.prod(shape[1:])))
    if step >= shape[0]:
        return out.copy_(draw(shape))
    for lo in range(0, shape[0], step):
        part = out[lo:lo + step]
        part.copy_(draw(part.shape))
    return out


def constant(shape, value, dtype, device, out=None):
    """A leaf of ``value`` everywhere, or ``out`` (its slot in a stacked
    tree) filled with it."""
    if out is None:
        return torch.full(tuple(shape), value, dtype=dtype, device=device)
    return out.fill_(value)


def rms_norm(x, gamma, eps=1e-6):
    """RMSNorm: statistics in fp32, the rsqrt cast to x's type, then
    x * scale * (1 + gamma) in x's type (the reference's order)."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + gamma.to(x.dtype))


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S). Rotates the two halves of the
    head (not interleaved pairs), in fp32, then casts back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)               # (hd/2,)
    ang = positions[..., :, None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    """GELU, tanh approximation (`jax.nn.gelu`'s default)."""
    return F.gelu(x, approximate="tanh")


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def gelu_mlp(x, w_up, w_down, b_up=None, b_down=None):
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    h = gelu(h)
    out = h @ w_down
    if b_down is not None:
        out = out + b_down
    return out


def cross_entropy(logits, labels, mask=None):
    """Token CE in float32, averaged over the valid tokens; labels < 0 are
    ignored, and so are tokens where ``mask`` is False.

    The gold logit is gathered (the reference reduces a one-hot product,
    for its vocab-sharded logits; both read the same float32 value, and the
    gather builds no (B, S, V) one-hot)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    nll = logz - gold
    valid = (labels >= 0) if mask is None else (mask & (labels >= 0))
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll) / torch.clamp_min(torch.sum(valid), 1)
