"""Input shapes per (architecture x input shape), allocating nothing.

Counterpart of `repro.launch.specs`. Its ``jax.ShapeDtypeStruct`` is a
tensor on the ``meta`` device here: shape and type, no storage. The batch
layouts defined here are the ones `models.model` takes.

Shapes:
  train_4k     seq 4,096    global_batch 256   (training)
  prefill_32k  seq 32,768   global_batch 32    (inference-prefill)
  decode_32k   seq 32,768   global_batch 128   (inference-decode: 1 new token)
  long_500k    seq 524,288  global_batch 1     (long-context decode)

Skips: HuBERT has no decode shapes (an encoder); the pure full-attention
decoders (StarCoder2, Qwen2.5, Pixtral) run long_500k only as their
sliding-window variant, which their configs enable. Only an
``attn_local`` layer applies ``sliding_window``: StarCoder2 and Pixtral
(pattern ``("attn",)``) attend globally at every other shape.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}
#: the patch embeddings a vision batch carries: min(N_PATCH_MAX, S // 4)
N_PATCH_MAX = 1024
_META = torch.device("meta")


def shape_skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    kind = SHAPES[shape]["kind"]
    if cfg.arch_type == "audio" and kind == "decode":
        return "encoder-only: no decode step"
    if shape == "long_500k":
        full_attn = cfg.block_pattern == ("attn",) and cfg.sliding_window is None
        if full_attn:
            return "pure full attention without SWA variant"
    return None


def uses_swa_variant(cfg: ModelConfig, shape: str) -> bool:
    """Dense full-attention archs run long_500k with their SWA variant."""
    return (
        shape == "long_500k"
        and cfg.block_pattern == ("attn",)
        and cfg.sliding_window is not None
        and cfg.arch_type in ("dense", "vlm")
    )


def effective_pattern(cfg: ModelConfig, shape: str) -> ModelConfig:
    """long_500k on full-attention dense archs -> all-local (SWA) variant."""
    if uses_swa_variant(cfg, shape):
        return cfg.scaled(block_pattern=("attn_local",))
    return cfg


def mesh_adapt(cfg: ModelConfig, model_axis: int) -> ModelConfig:
    """Pad q heads and replicate kv heads so that the head axes divide the
    model axis: zero q heads add nothing through wo, and each q group still
    sees its own kv head, so the function is the same."""
    if cfg.use_mla or not any(k.startswith("attn") for k in cfg.block_pattern):
        return cfg
    H, KV = cfg.n_heads, cfg.n_kv_heads
    H_pad = -(-H // model_axis) * model_axis if H % model_axis else H
    KV_eff = KV * model_axis // math.gcd(KV, model_axis)
    if KV_eff > H_pad:
        KV_eff = H_pad
    if H_pad % KV_eff:
        KV_eff = H_pad  # degenerate: go MHA
    if H_pad == H and KV_eff == KV:
        return cfg
    return cfg.scaled(n_heads=H_pad, n_kv_heads=KV_eff, head_dim=cfg.hd)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def input_specs(cfg: ModelConfig, shape: str, batch: int | None = None,
                seq: int | None = None) -> dict:
    """The train/prefill batch of ``shape`` as meta tensors: {"tokens",
    "labels"} (B, S) int32, with "patch_embeds" (B, min(1024, S // 4),
    frontend_dim) bf16 for vision; {"frame_embeds" (B, S, frontend_dim)
    bf16, "labels", "mask" (B, S) bool} for audio. ``batch`` and ``seq``,
    if given, replace the shape's B and S (a run cut to fit one card)."""
    info = SHAPES[shape]
    B, S = batch or info["batch"], seq or info["seq"]
    tok = _spec((B, S), torch.int32)
    if cfg.frontend == "audio":
        return {
            "frame_embeds": _spec((B, S, cfg.frontend_dim), torch.bfloat16),
            "labels": tok,
            "mask": _spec((B, S), torch.bool),
        }
    out = {"tokens": tok, "labels": tok}
    if cfg.frontend == "vision":
        n_patch = min(N_PATCH_MAX, S // 4)
        out["patch_embeds"] = _spec((B, n_patch, cfg.frontend_dim), torch.bfloat16)
    return out


def decode_specs(cfg: ModelConfig, shape: str):
    """(token (B, 1) int32, pos () int32, the per-layer cache of
    `models.model.init_cache`) as meta tensors, for ``shape``'s effective
    pattern. Raises as `init_cache` does for what the port does not run."""
    from repro_torch.models import model as M

    info = SHAPES[shape]
    B, S = info["batch"], info["seq"]
    cfg = effective_pattern(cfg, shape)
    cache = M.init_cache(cfg, B, S, _META)
    return _spec((B, 1), torch.int32), _spec((), torch.int32), cache
