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

Under a mesh (``par``) each rank holds its ``model`` shard
(`parallel.sharding`): the time mix's r/k/v/g columns, decay, bonus and
group norm on its heads (the WKV kernel launches once per shard and
layer), ``wo``'s partial sums reduced; the channel mix's d_ff columns,
``cv``'s partial sums reduced, and ``cr``'s d columns, whose product with
the reduced sum is gathered. The carried token shifts are d-sharded
(`parallel.sharding.cache_specs`) and gathered for the step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.parallel import collectives as C

from .layers import constant, dense_init

LORA = 64   # rank of the decay's LoRA


def init_rwkv_params(generator, cfg, dtype, out=None) -> dict:
    """The time and channel mix's parameters; with ``out`` (their slots in a
    stacked tree, by name) written there (`layers.dense_init`)."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    dev = generator.device
    o = out or {}
    full = lambda name, shape, value: constant(shape, value, dtype, dev, o.get(name))
    normal = lambda name, shape, scale=None: dense_init(generator, shape, scale, dtype, o.get(name))
    return {
        "mu": full("mu", (5, d), 0.5),                  # shift-mix for r, k, v, g, w
        "wr": normal("wr", (d, d)),
        "wk": normal("wk", (d, d)),
        "wv": normal("wv", (d, d)),
        "wg": normal("wg", (d, d)),
        "w_lora_a": normal("w_lora_a", (d, LORA)),
        "w_lora_b": normal("w_lora_b", (LORA, d), 0.01),
        "w_bias": full("w_bias", (d,), -6.0),           # slow default decay
        "u": normal("u", (H, hd)),                      # bonus
        "ln_g": full("ln_g", (d,), 1.0),                # per-head group norm
        "ln_b": full("ln_b", (d,), 0.0),
        "wo": normal("wo", (d, d)),
        # channel mix
        "mu_c": full("mu_c", (2, d), 0.5),
        "ck": normal("ck", (d, cfg.d_ff)),
        "cv": normal("cv", (cfg.d_ff, d)),
        "cr": normal("cr", (d, d)),
    }


def _shift(x, x_prev):
    """Token shift: the previous token's features ((B, S, d), carry (B, d))."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _decay(p, xw, par=None, sharded=False):
    """Data-dependent per-channel decay in (0, 1): exp(-exp(.)). The LoRA
    products in the model's type, the double exponential in float32."""
    a = torch.tanh(xw @ p["w_lora_a"])
    loraw = (C.copy(a, par) if sharded else a) @ p["w_lora_b"]
    return torch.exp(-torch.exp((p["w_bias"] + loraw).float()))


def _group_norm(y, g, b, H, eps=1e-5):
    """Per-head norm in float32 with the population variance (`jnp.var`)."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, d // H).float()
    mean = torch.mean(yh, -1, keepdim=True)
    var = torch.mean(torch.square(yh - mean), -1, keepdim=True)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return (yh.reshape(B, S, d) * g + b).to(y.dtype)


def _shift_state(state, key, x, par, sharded):
    """The carried token shift (B, d), gathered where it is d-sharded, or
    zeros for a fresh sequence."""
    if state is None:
        return x.new_zeros((x.shape[0], x.shape[2]))
    return C.gather(state[key], par) if sharded else state[key]


def time_mix(p, cfg, x, state=None, use_kernel="auto", par=None):
    """x: (B, S, d); state: {"shift": (B, d), "wkv": (B, H, hd, hd)} carried
    from earlier tokens, or None for a fresh sequence. Returns (out, state).
    From a carried state the new state holds the last token and the
    recurrence's final state. A fresh sequence returns no state (None): like
    the TPU kernel, the CUDA kernel writes only y, and the forward path
    discards the state. ``use_kernel`` as in `ops.rwkv6_scan`, which raises
    for True with a carried state. Under a mesh, H is the local heads.
    """
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    sharded = par is not None and par.sharded(p["wr"].shape[1], d)
    if par is not None and sharded != par.sharded(p["u"].shape[0], d // hd):
        raise ValueError(f"{cfg.name}: d {d} and its {d // hd} heads do not split alike over {par.M}")
    H = p["u"].shape[0]
    d_l = H * hd
    prev = _shift_state(state, "shift", x, par, sharded)
    xs = _shift(x, prev)
    mu = p["mu"]
    mix = lambda i: C.copy(_mix(x, xs, mu[i]), par) if sharded else _mix(x, xs, mu[i])
    r = (mix(0) @ p["wr"]).reshape(B, S, H, hd)
    k = (mix(1) @ p["wk"]).reshape(B, S, H, hd)
    v = (mix(2) @ p["wv"]).reshape(B, S, H, hd)
    g = mix(3) @ p["wg"]
    w = _decay(p, _mix(x, xs, mu[4]), par, sharded).reshape(B, S, H, hd)    # float32
    # (B, H, S, hd) views of the (B, S, H, hd) projections in the model's
    # type; the scan casts them to float32 (exactly) and returns y in float32
    rs, ks, vs, ws = (t.transpose(1, 2) for t in (r, k, v, w))
    y, wkv = wkv_ops.rwkv6_scan(rs, ks, vs, ws, p["u"], None if state is None else state["wkv"],
                                out_dtype=torch.float32, use_kernel=use_kernel)
    y = y.transpose(1, 2).reshape(B, S, d_l)
    y = _group_norm(y, p["ln_g"].float(), p["ln_b"].float(), H)
    y = y.to(x.dtype) * F.silu(g)
    out = y @ p["wo"]
    if sharded:
        out = C.reduce(out, par)
    if state is None:
        return out, None
    last = C.split(x[:, -1], par) if sharded else x[:, -1]
    return out, {"shift": last, "wkv": wkv.to(state["wkv"].dtype)}


def channel_mix(p, cfg, x, state=None, par=None):
    """The RWKV FFN. state: {"shift_c": (B, d)}, or None for a fresh sequence."""
    d = x.shape[2]
    ff_sharded = par is not None and par.sharded(p["ck"].shape[1], cfg.d_ff)
    d_sharded = par is not None and par.sharded(p["cr"].shape[1], d)
    prev = _shift_state(state, "shift_c", x, par, d_sharded)
    xs = _shift(x, prev)
    mu = p["mu_c"]
    xk, xr = _mix(x, xs, mu[0]), _mix(x, xs, mu[1])
    k = torch.square(torch.relu((C.copy(xk, par) if ff_sharded else xk) @ p["ck"]))
    kv = k @ p["cv"]
    if ff_sharded:
        kv = C.reduce(kv, par)
    if d_sharded:
        r = torch.sigmoid(C.copy(xr, par) @ p["cr"])
        out = C.gather(r * C.split(kv, par), par)
    else:
        out = torch.sigmoid(xr @ p["cr"]) * kv
    last = C.split(x[:, -1], par) if d_sharded else x[:, -1]
    return out, {"shift_c": last}


def init_rwkv_state(cfg, batch, dtype, device) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    return {
        "shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "shift_c": torch.zeros((batch, d), dtype=dtype, device=device),
    }
