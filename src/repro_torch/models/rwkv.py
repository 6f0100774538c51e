"""RWKV6 "Finch" blocks (arXiv:2404.05892): data-dependent decay WKV.

Counterpart of `repro.models.rwkv`, with the reference's casts. Time mix: a
per-head linear-attention state S in R^{hd x hd} updated with a
data-dependent per-channel decay w_t:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

The recurrence runs through `kernels.rwkv6_scan.ops.rwkv6_scan`: a fresh
sequence (``state=None``: prefill, whose final state the forward path
discards) through the CUDA kernel on a card and the plain recurrence on the
CPU; a carried state (decode: one step from the cached state) through the
plain recurrence, as the reference's ``lax.scan`` does.
Channel mix is the RWKV squared-ReLU FFN. The reference's simplification is
kept: token shift uses learned static lerp weights (the low-rank
data-dependent decay is kept, the per-token-shift LoRA omitted).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops

from .layers import dense_init

LORA = 64   # rank of the decay's LoRA


def init_rwkv_params(generator, cfg, dtype) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    dev = generator.device
    full = lambda shape, value: torch.full(shape, value, dtype=dtype, device=dev)
    return {
        "mu": full((5, d), 0.5),                        # shift-mix for r, k, v, g, w
        "wr": dense_init(generator, (d, d), dtype=dtype),
        "wk": dense_init(generator, (d, d), dtype=dtype),
        "wv": dense_init(generator, (d, d), dtype=dtype),
        "wg": dense_init(generator, (d, d), dtype=dtype),
        "w_lora_a": dense_init(generator, (d, LORA), dtype=dtype),
        "w_lora_b": dense_init(generator, (LORA, d), scale=0.01, dtype=dtype),
        "w_bias": full((d,), -6.0),                     # slow default decay
        "u": dense_init(generator, (H, hd), dtype=dtype),   # bonus
        "ln_g": full((d,), 1.0),                        # per-head group norm
        "ln_b": full((d,), 0.0),
        "wo": dense_init(generator, (d, d), dtype=dtype),
        # channel mix
        "mu_c": full((2, d), 0.5),
        "ck": dense_init(generator, (d, cfg.d_ff), dtype=dtype),
        "cv": dense_init(generator, (cfg.d_ff, d), dtype=dtype),
        "cr": dense_init(generator, (d, d), dtype=dtype),
    }


def _shift(x, x_prev):
    """Token shift: the previous token's features ((B, S, d), carry (B, d))."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _decay(p, xw):
    """Data-dependent per-channel decay in (0, 1): exp(-exp(.)). The LoRA
    products in the model's type, the double exponential in float32."""
    loraw = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp((p["w_bias"] + loraw).float()))


def _group_norm(y, g, b, H, eps=1e-5):
    """Per-head norm in float32 with the population variance (`jnp.var`)."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).float()
    mean = torch.mean(yh, -1, keepdim=True)
    var = torch.mean(torch.square(yh - mean), -1, keepdim=True)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return (yh.reshape(B, S, d) * g + b).to(y.dtype)


def time_mix(p, cfg, x, state=None, use_kernel="auto"):
    """x: (B, S, d); state: {"shift": (B, d), "wkv": (B, H, hd, hd)} carried
    from earlier tokens, or None for a fresh sequence. Returns (out, state).

    From a carried state the new state holds the last token and the
    recurrence's final state. A fresh sequence returns no state (None): like
    the TPU kernel, the CUDA kernel writes only y, and the forward path
    discards the state. ``use_kernel`` as in `ops.rwkv6_scan`, which raises
    for True with a carried state.
    """
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    prev = state["shift"] if state is not None else x.new_zeros((B, d))
    xs = _shift(x, prev)
    mu = p["mu"]
    r = (_mix(x, xs, mu[0]) @ p["wr"]).reshape(B, S, H, hd)
    k = (_mix(x, xs, mu[1]) @ p["wk"]).reshape(B, S, H, hd)
    v = (_mix(x, xs, mu[2]) @ p["wv"]).reshape(B, S, H, hd)
    g = _mix(x, xs, mu[3]) @ p["wg"]
    w = _decay(p, _mix(x, xs, mu[4])).reshape(B, S, H, hd)    # float32

    # (B, H, S, hd) views of the (B, S, H, hd) projections in the model's
    # type; the scan casts them to float32 (exactly) and returns y in float32
    rs, ks, vs, ws = (t.transpose(1, 2) for t in (r, k, v, w))
    y, wkv = wkv_ops.rwkv6_scan(rs, ks, vs, ws, p["u"], None if state is None else state["wkv"],
                                out_dtype=torch.float32, use_kernel=use_kernel)
    y = y.transpose(1, 2).reshape(B, S, d)
    y = _group_norm(y, p["ln_g"].float(), p["ln_b"].float(), H)
    y = y.to(x.dtype) * F.silu(g)
    if state is None:
        return y @ p["wo"], None
    return y @ p["wo"], {"shift": x[:, -1], "wkv": wkv.to(state["wkv"].dtype)}


def channel_mix(p, cfg, x, state=None):
    """The RWKV FFN. state: {"shift_c": (B, d)}, or None for a fresh sequence."""
    prev = state["shift_c"] if state is not None else x.new_zeros((x.shape[0], x.shape[2]))
    xs = _shift(x, prev)
    mu = p["mu_c"]
    k = torch.square(torch.relu(_mix(x, xs, mu[0]) @ p["ck"]))
    kv = k @ p["cv"]
    r = torch.sigmoid(_mix(x, xs, mu[1]) @ p["cr"])
    return r * kv, {"shift_c": x[:, -1]}


def init_rwkv_state(cfg, batch, dtype, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    return {
        "shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
    }
