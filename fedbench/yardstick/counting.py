"""The work a kernel or a prefill needs, counted from shapes alone.

Frozen from chip_smoke.py (`attention_pairs` and the bf16 branch of
`flash_bound` at :965 and :976, `wkv_bound` and `WKV_OPS*` at :1140 and
:379), so that a rewritten kernel is judged against the same work whatever
implements it. The pair
count is written in closed form here; tests/test_fedbench_counting.py holds
it to chip_smoke.py's loop.
"""
from __future__ import annotations

from . import peaks

#: float32 operations WKV6 needs per (step, key, value column): the FMA of
#: r_i S_ij into y_j (2), k_i v_j, the FMA w_i S_ij + k_i v_j (2); per (step,
#: key) the bonus term's r_i u_i k_i and its sum (3); per (step, value column)
#: v_j times that sum and its add into y_j (2)
WKV_OPS, WKV_OPS_KEY, WKV_OPS_COL = 5, 3, 2


def attention_pairs(S: int, causal: bool, window: int | None) -> int:
    """Unmasked (query, key) pairs of one (batch, head) at positions 0..S-1:
    a key k is kept for query q when k <= q (causal) and q - k < window."""
    if causal:
        if window is None or S <= window:
            return S * (S + 1) // 2
        return window * (window + 1) // 2 + (S - window) * window
    if window is None or S <= window:
        return S * S
    return S * S - (S - window) * (S - window + 1) // 2


def flash_bound(B, S, H, KV, hd, causal, window):
    """(seconds, 'bytes'|'operations'): the least time of one bf16 attention
    call: q, k, v read once and the output written once at the HBM rate,
    against 4 hd operations per kept pair and head at 989 TFLOP/s."""
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    flops = 4 * hd * B * H * attention_pairs(S, causal, window)
    t_bytes, t_ops = nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.BF16_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_ops(B, H, S, hd) -> int:
    """Float32 operations of WKV6 over (B, H, S, hd), the bonus term factored
    out of the (key, column) loop."""
    return B * H * S * (WKV_OPS * hd * hd + (WKV_OPS_KEY + WKV_OPS_COL) * hd)


def wkv_bound(B, H, S, hd, rkv_bytes, w_bytes, y_bytes):
    """(seconds, 'bytes'|'operations'): `wkv_ops` at the float32 peak, against
    r, k, v and w read once, y written once and u (float32) read once."""
    nbytes = B * H * S * hd * (3 * rkv_bytes + w_bytes + y_bytes) + 4 * H * hd
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S
    t_ops = wkv_ops(B, H, S, hd) / peaks.FP32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def layer_kinds(model: dict) -> list[str]:
    """Every layer's block kind: the config's ``block_pattern`` cycled."""
    pat = model["block_pattern"]
    return [pat[i % len(pat)] for i in range(model["n_layers"])]


def layer_window(model: dict, kind: str):
    """The attention window a layer applies: the program windows its
    ``attn_local`` layers only (ModelConfig.sliding_window's comment)."""
    return model.get("sliding_window") if kind == "attn_local" else None


def prefill_flops(model: dict, matmul_params: int, S: int, B: int = 1) -> float:
    """Model FLOPs of one prefill of B sequences of S tokens: 2 x the matmul
    parameters (LM head included) x tokens, attention's 4 hd per kept pair
    and head, and WKV6's float32 operations."""
    flops = 2.0 * matmul_params * B * S
    hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
    for kind in layer_kinds(model):
        if kind.startswith("attn"):
            pairs = attention_pairs(S, model.get("causal", True), layer_window(model, kind))
            flops += 4.0 * hd * B * model["n_heads"] * pairs
        elif kind == "rwkv":
            rhd = model.get("rwkv_head_dim", 64)
            flops += wkv_ops(B, model["d_model"] // rhd, S, rhd)
    return flops
