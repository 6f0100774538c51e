"""Mamba (S6) selective-state-space block, as interleaved in Jamba.

Counterpart of `repro.models.mamba`, with the reference's casts:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t        (per channel, state N)
    y_t = C_t h_t + D x_t

The scan runs through `kernels.mamba_scan.ops.mamba_scan`: a fresh sequence
(``state=None``: prefill, whose final state the forward path discards)
through the CUDA kernel on a card and the plain recurrence on the CPU; a
carried state (decode: one step from the cached (conv window, h)) through
the plain recurrence, as the reference's ``lax.scan`` does. The scan takes
the model's tensors as they are: x in the model's type, dt in float32, and
B and C as column views of ``x_proj``'s output in the model's type (the
reference casts them to float32, which is exact), and it adds D x inside,
in float32, where the reference adds it after its scan: both are
(sum_n h C) + D x. Only h (B, d_inner, N) is carried; the (B, S, d_inner, N)
tensor of every step's state is never built. With ``cfg.ssm_io_bf16`` x, dt,
B and C reach the scan rounded to bf16, as the reference streams them (the
math stays float32, and y keeps the model's type).

Under a mesh (``par``) each rank holds its ``model`` slice of d_inner
(`parallel.sharding`): ``in_proj``'s column block of [x, z] is gathered and
each rank keeps its slices of x and z, the conv, the scan (the kernel
included, once per shard and layer) and the state cover the local
channels, ``x_proj``'s row-sharded partial sums (dt, B, C) are reduced
before the scan, and ``out_proj``'s partial sums after it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.parallel import collectives as C

from .layers import constant, dense_init

#: leaves kept in float32 whatever the model's type, as the reference's
#: `init_mamba_params` makes them
FLOAT32_LEAVES = ("dt_bias", "A_log", "D")


def _dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The type of the Mamba leaf ``name`` in a model of type ``dtype``."""
    return torch.float32 if name in FLOAT32_LEAVES else dtype


def init_mamba_params(generator, cfg, dtype, out=None) -> dict:
    """The Mamba block's parameters; with ``out`` (their slots in a stacked
    tree, by name) written there (`layers.dense_init`)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    R = _dt_rank(cfg)
    dev = generator.device
    f32 = torch.float32
    o = out or {}
    normal = lambda name, shape: dense_init(generator, shape, dtype=dtype, out=o.get(name))
    A = torch.arange(1, N + 1, dtype=f32, device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": normal("in_proj", (d, 2 * di)),
        "conv_w": normal("conv_w", (cfg.ssm_conv, di)),
        "conv_b": constant((di,), 0.0, dtype, dev, o.get("conv_b")),
        "x_proj": normal("x_proj", (di, R + 2 * N)),
        "dt_proj": normal("dt_proj", (R, di)),
        "dt_bias": constant((di,), float(torch.log(torch.expm1(torch.tensor(0.01)))), f32, dev,
                            o.get("dt_bias")),
        "A_log": torch.log(A) if "A_log" not in o else o["A_log"].copy_(torch.log(A)),  # (di, N) float32
        "D": constant((di,), 1.0, f32, dev, o.get("D")),
        "out_proj": normal("out_proj", (di, d)),
    }


def _causal_conv(x, w, b, carry=None):
    """Depthwise causal conv. x: (B, S, di); w: (K, di); carry: (B, K-1, di)
    or None for zeros. The K shifted products are summed in the reference's
    order, each op rounded in x's type (`F.conv1d` would sum in another
    order, and through cuDNN in TF32 for float32). Returns (out, the last
    K-1 inputs: the decode carry)."""
    K = w.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    S = x.shape[1]
    out = xp[:, :S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, -(K - 1):]


def _ssm_inputs(p, cfg, x, par=None):
    """The pre-scan projections of the convolved x (B, S, di). Returns
    (dt (B, S, di) float32, B (B, S, N), C (B, S, N)), B and C as column
    views of ``x_proj``'s output in the model's type. (The reference takes
    the concatenation [x, z] and splits it again; z plays no part.)"""
    N = cfg.ssm_state
    R = _dt_rank(cfg)
    proj = x @ p["x_proj"]
    if par is not None and par.sharded(x.shape[-1], cfg.ssm_expand * cfg.d_model):
        # row-sharded: partial sums over model, then used per rank's channels
        proj = C.copy(C.reduce(proj, par), par)
    dt = F.softplus((proj[..., :R] @ p["dt_proj"]).float() + p["dt_bias"])
    return dt, proj[..., R:R + N], proj[..., R + N:]


def mamba_forward(p, cfg, x_in, state=None, use_kernel="auto", par=None):
    """x_in: (B, S, d); state: {"conv": (B, K-1, di), "h": (B, di, N)}
    carried from earlier tokens, or None for a fresh sequence. Returns
    (out, state).

    From a carried state the new state holds the last K-1 conv inputs and
    the scan's final h. A fresh sequence returns no state (None): like the
    TPU kernel, the CUDA kernel writes only y, and the forward path discards
    the state. ``use_kernel`` as in `ops.mamba_scan`, which raises for True
    with a carried state.
    """
    di = cfg.ssm_expand * cfg.d_model
    sharded = par is not None and par.sharded(p["in_proj"].shape[1], 2 * di)
    if sharded:
        xz = C.gather(C.copy(x_in, par) @ p["in_proj"], par)
        x, z = C.split(xz[..., :di], par), C.split(xz[..., di:], par)
    else:
        xz = x_in @ p["in_proj"]
        x, z = xz[..., :di], xz[..., di:]
    x, conv_carry = _causal_conv(x, p["conv_w"], p["conv_b"],
                                 None if state is None else state["conv"])
    x = F.silu(x)
    dt, Bm, Cm = _ssm_inputs(p, cfg, x, par)
    xs = x
    if cfg.ssm_io_bf16:
        # x keeps the model's type (y is cast to it, as the reference casts
        # its y back), rounded to bf16: D x is the reference's bf16 x times D
        bf16 = torch.bfloat16
        xs = x.to(bf16).to(x.dtype)
        dt, Bm, Cm = dt.to(bf16), Bm.to(bf16), Cm.to(bf16)
    A = -torch.exp(p["A_log"])                               # (di, N)
    y, h = scan_ops.mamba_scan(xs, dt, Bm, Cm, A, p["D"], None if state is None else state["h"],
                               use_kernel=use_kernel)
    out = (y * F.silu(z)) @ p["out_proj"]
    if sharded:
        out = C.reduce(out, par)
    if state is None:
        return out, None
    return out, {"conv": conv_carry, "h": h}


def init_mamba_state(cfg, batch, dtype, device) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32, device=device),
    }
