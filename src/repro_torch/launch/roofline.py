"""Roofline terms of a traced step, per device, on the card's constants.

Counterpart of `repro.launch.roofline`. Every count is per device
(`launch.op_cost` counts on the local shards), so each term is a time
lower bound on one NVIDIA H100 80GB HBM3 (`launch.mesh`):

  compute    = dot FLOPs per device / 989 TFLOP/s (bf16 dense)
  memory     = HBM bytes per device / 3.35 TB/s
  collective = collective bytes per device / 450 GB/s (NVLink, one direction)

The memory analysis is `torch.distributed._tools.mem_tracker.MemTracker`'s
peak for the device (a trace on fake tensors allocates nothing, and the
tracker counts what would be live).
"""
from __future__ import annotations

from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16


def roofline(cost: dict, mem: dict, coll: dict) -> dict:
    """Three-term per-device roofline (seconds) + dominant bottleneck."""
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    bytes_coll = float(coll.get("total", 0))
    terms = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": bytes_coll / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    return {
        **terms,
        "dominant": dominant,
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": bytes_hbm,
        "collective_bytes_per_dev": bytes_coll,
        "memory_analysis": mem,
    }


def memory_dict(peak: dict, argument_bytes: int, output_bytes: int, alias_bytes: int) -> dict:
    """The reference's memory-analysis keys from a `MemTracker` peak
    snapshot of one device (``{category: bytes, "Total": bytes}``), the
    step's argument bytes (parameters, optimizer state, batch, cache: the
    local shards) and output bytes, of which ``alias_bytes`` update
    arguments in place (the train step's state, the decode cache)."""
    total = int(peak.get("Total", 0))
    return {
        "argument_size_in_bytes": int(argument_bytes),
        "output_size_in_bytes": int(output_bytes),
        "temp_size_in_bytes": max(0, total - int(argument_bytes)),
        "generated_code_size_in_bytes": 0,
        "alias_size_in_bytes": int(alias_bytes),
        "total_hbm_bytes": total,
        "peak_by_category": {str(k): int(v) for k, v in peak.items()},
    }


def model_flops(cfg, shape_info: dict, kind: str) -> float:
    """MODEL_FLOPS: 6*N_active*tokens (train) or 2*N_active*tokens (serve),
    GLOBAL (multiply ratios accordingly)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape_info["batch"] * shape_info["seq"]
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape_info["batch"] * shape_info["seq"]
        return 2.0 * n_active * tokens
    tokens = shape_info["batch"]  # decode: one token per sequence
    return 2.0 * n_active * tokens
