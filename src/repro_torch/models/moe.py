"""The dense FFN of a block (swiglu / GeGLU / gelu+bias).

Counterpart of the dense part of `repro.models.moe`: `init_dense_ffn` and
`dense_ffn`. The routed MoE layer is not ported yet (ROADMAP.md §1, item
12): a config with experts raises `NotImplementedError` in
`repro_torch.models.model`.
"""
from __future__ import annotations

import torch

from .layers import dense_init, gelu, gelu_mlp, swiglu


def init_dense_ffn(generator, cfg, dtype, d_ff=None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.ffn_kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, (d, ff), dtype=dtype),
            "w_up": dense_init(generator, (d, ff), dtype=dtype),
            "w_down": dense_init(generator, (ff, d), dtype=dtype),
        }
    dev = generator.device
    return {
        "w_up": dense_init(generator, (d, ff), dtype=dtype),
        "b_up": torch.zeros((ff,), dtype=dtype, device=dev),
        "w_down": dense_init(generator, (ff, d), dtype=dtype),
        "b_down": torch.zeros((d,), dtype=dtype, device=dev),
    }


def dense_ffn(p, cfg, x):
    if "w_gate" in p:
        if cfg.ffn_kind == "geglu":  # gemma2: gelu-gated
            g = x @ p["w_gate"]
            u = x @ p["w_up"]
            return (gelu(g) * u) @ p["w_down"]
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return gelu_mlp(x, p["w_up"], p["w_down"], p.get("b_up"), p.get("b_down"))

