"""Model assembly: embed -> layers -> final norm -> head; prefill and decode.

Counterpart of `repro.models.model` for ``attn``/``attn_local`` and
``mamba`` blocks with a dense FFN and for ``rwkv`` blocks (time mix and
channel mix). The
reference stacks each stage's per-period parameters and scans over them;
here every layer is its own `Block` in an `nn.ModuleList`,
in the reference's order (stage by stage, period by period, pattern position
by pattern position), with the reference's parameter names (``ln``,
``attn.wq``, ``ffn.w_gate``, ...). Parameters are built from plain dicts of
tensors, by `init_params` (random, from a `torch.Generator`) or by
`repro_torch.bridge.lm_params_from_numpy` (the reference's pytree).

Entry points:
  * forward(params, cfg, batch)               -> (logits, aux)
  * prefill(params, cfg, batch)               -> logits
  * decode_step(params, cfg, token, pos, cache) -> (logits, cache)

MoE and MLA layers, frontends, meshes and the configs the registry lists
in ``NOT_PORTED`` are not ported yet and raise `NotImplementedError`
(ROADMAP.md §1) before anything is allocated: the published Jamba config,
with its experts, raises; its dense cut (``n_experts=0``) runs.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.registry import NOT_PORTED, canonical
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rwk
from .config import ModelConfig
from .layers import dense_init, dtype_of, rms_norm, softcap


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer: ``ln``, ``attn`` {wq, wk, wv, wo[, bq, bk, bv]}, optional
    ``post_ln``, ``ffn_ln``, ``ffn`` {w_gate, w_up, w_down | w_up, b_up,
    w_down, b_down}, optional ``post_ffn_ln``; a ``mamba`` layer has
    ``mamba`` {in_proj, conv_w, ...} in place of ``attn``; an ``rwkv`` layer
    has ``ln``, ``rwkv`` (time and channel mix), optional ``post_ln`` and
    ``ffn_ln``."""

    def __init__(self, kind: str, p: dict):
        super().__init__()
        self.kind = kind
        for name, value in p.items():
            if isinstance(value, dict):
                self.add_module(name, nn.ParameterDict({k: _param(x) for k, x in value.items()}))
            else:
                self.register_parameter(name, _param(value))


class LM(nn.Module):
    """``embed`` (V, d), ``final_ln`` (d,), ``head`` (d, V) unless tied, and
    the ``layers``."""

    def __init__(self, cfg: ModelConfig, embed, final_ln, layers: list[dict], head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(embed)
        self.final_ln = _param(final_ln)
        if head is not None:
            self.head = _param(head)
        kinds = layer_kinds(cfg)
        if len(layers) != len(kinds):
            raise ValueError(f"{cfg.name}: {len(layers)} layers given, the config has {len(kinds)}")
        self.layers = nn.ModuleList(Block(kind, p) for kind, p in zip(kinds, layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def check_ported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for what the port does not run yet."""
    if cfg.use_mla or cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE/MLA layers are not ported yet: ROADMAP.md §1, item 12")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend is not ported yet: ROADMAP.md §1, item 11")
    arch = canonical(cfg.name)
    if arch in NOT_PORTED:
        raise NotImplementedError(f"{cfg.name} is not ported yet: ROADMAP.md §1, {NOT_PORTED[arch]}")
    for kind in cfg.block_pattern:
        if kind not in ("attn", "attn_local", "mamba", "rwkv"):
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if cfg.ssm_io_bf16:
        raise NotImplementedError(f"{cfg.name}: ssm_io_bf16 (bf16 scan inputs) is not ported")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The block kind of every layer, in the reference's order (the stages of
    `ModelConfig.stages`, each a cycle over ``block_pattern``)."""
    check_ported(cfg)
    return [kind for _name, n_periods, _moe in cfg.stages()
            for _ in range(n_periods) for kind in cfg.block_pattern]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ModelConfig, kind: str) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dt, device=generator.device)
    p = {"ln": zeros()}
    if kind == "rwkv":
        p["rwkv"] = rwk.init_rwkv_params(generator, cfg, dt)
    elif kind == "mamba":
        p["mamba"] = mam.init_mamba_params(generator, cfg, dt)
    else:
        p["attn"] = attn.init_attn_params(generator, cfg, dt)
    if cfg.post_norm:
        p["post_ln"] = zeros()
    p["ffn_ln"] = zeros()
    if kind == "rwkv":  # the channel mix, in ``rwkv``, is its FFN
        return p
    p["ffn"] = moe_mod.init_dense_ffn(generator, cfg, dt)
    if cfg.post_norm:
        p["post_ffn_ln"] = zeros()
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator) -> LM:
    """Random parameters of the reference's law, on the generator's device."""
    kinds = layer_kinds(cfg)                  # raises for what is not ported, before allocating
    dt = dtype_of(cfg)
    d = cfg.d_model
    embed = dense_init(generator, (cfg.vocab, d), scale=0.02, dtype=dt)
    head = None if cfg.tie_embeddings else dense_init(generator, (d, cfg.vocab), dtype=dt)
    layers = [_init_block(generator, cfg, kind) for kind in kinds]
    final_ln = torch.zeros((d,), dtype=dt, device=generator.device)
    return LM(cfg, embed, final_ln, layers, head)


# ---------------------------------------------------------------------------
# blocks, embeddings, head
# ---------------------------------------------------------------------------

def _block_window(cfg, kind):
    return cfg.sliding_window if kind == "attn_local" else None


def _ffn(blk: Block, cfg, x):
    h = rms_norm(x, blk.ffn_ln, cfg.norm_eps)
    out = moe_mod.dense_ffn(blk.ffn, cfg, h)
    if cfg.post_norm:
        out = rms_norm(out, blk.post_ffn_ln, cfg.norm_eps)
    return x + out


def _post(blk: Block, cfg, inner):
    return rms_norm(inner, blk.post_ln, cfg.norm_eps) if cfg.post_norm else inner


def _channel_mix(blk: Block, cfg, x, state):
    """The second residual of an ``rwkv`` block; returns (x, channel state)."""
    out, c = rwk.channel_mix(blk.rwkv, cfg, rms_norm(x, blk.ffn_ln, cfg.norm_eps), state)
    return x + out, c


def _apply_block(blk: Block, cfg, x, positions, use_kernel):
    h = rms_norm(x, blk.ln, cfg.norm_eps)
    if blk.kind == "rwkv":
        # a fresh sequence: both mixes start from the zero state, and their
        # final states are discarded, as in the reference's forward
        inner, _ = rwk.time_mix(blk.rwkv, cfg, h, None, use_kernel=use_kernel)
        return _channel_mix(blk, cfg, x + _post(blk, cfg, inner), None)[0]
    if blk.kind == "mamba":
        # a fresh sequence from the zero state, its final state discarded
        inner, _ = mam.mamba_forward(blk.mamba, cfg, h, None, use_kernel=use_kernel)
    else:
        inner = attn.gqa_forward(
            blk.attn, cfg, h, positions,
            window=_block_window(cfg, blk.kind), use_kernel=use_kernel,
        )
    return _ffn(blk, cfg, x + _post(blk, cfg, inner))


def _embed(params: LM, cfg, batch):
    if cfg.frontend is not None or "tokens" not in batch:
        raise NotImplementedError("frontends are not ported yet: ROADMAP.md §1, item 11")
    x = params.embed[batch["tokens"]]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions


def _head(params: LM, cfg, x):
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.head
    logits = x @ w
    if cfg.final_softcap:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("meshes (sharded models) are not ported yet: ROADMAP.md §1, item 11")


def forward(params: LM, cfg: ModelConfig, batch, mesh=None, use_kernel="auto"):
    """Logits (B, S, V) of ``batch["tokens"]`` (B, S), and the auxiliary loss
    (0 without MoE). ``use_kernel`` picks the route of the attention, the WKV
    recurrence and the selective scan: "auto" (the CUDA kernels iff on a
    card), True (the kernels; CPU tensors raise) or False (the plain
    versions)."""
    _no_mesh(mesh)
    x, positions = _embed(params, cfg, batch)
    for blk in params.layers:
        x = _apply_block(blk, cfg, x, positions, use_kernel)
    return _head(params, cfg, x), 0.0


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> list[dict]:
    """One cache per layer: a KV cache (`attention.init_kv_cache`), for an
    ``rwkv`` layer its state {"shift", "wkv", "shift_c"} (`rwkv.init_rwkv_state`),
    for a ``mamba`` layer its state {"conv", "h"} (`mamba.init_mamba_state`)."""
    dt = dtype_of(cfg)

    def one(kind):
        if kind == "rwkv":
            return rwk.init_rwkv_state(cfg, batch, dt, device)
        if kind == "mamba":
            return mam.init_mamba_state(cfg, batch, dt, device)
        return attn.init_kv_cache(cfg, batch, max_len, _block_window(cfg, kind), dt, device)

    return [one(kind) for kind in layer_kinds(cfg)]


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, pos: int, cache, mesh=None):
    """token: (B, 1) int; pos: the position of every row. Updates ``cache``
    in place and returns (logits (B, 1, V), cache)."""
    _no_mesh(mesh)
    x = params.embed[token]
    for blk, c in zip(params.layers, cache):
        h = rms_norm(x, blk.ln, cfg.norm_eps)
        if blk.kind == "rwkv":
            # one step of the plain recurrence from the carried state
            inner, c_t = rwk.time_mix(blk.rwkv, cfg, h, c)
            x, c_c = _channel_mix(blk, cfg, x + _post(blk, cfg, inner), c)
            c.update(c_t, **c_c)
            continue
        if blk.kind == "mamba":
            # one step of the plain recurrence from the carried state
            inner, new = mam.mamba_forward(blk.mamba, cfg, h, c)
            c.update(new)
        else:
            inner, _ = attn.gqa_decode(blk.attn, cfg, h, pos, c, window=_block_window(cfg, blk.kind))
        x = _ffn(blk, cfg, x + _post(blk, cfg, inner))
    return _head(params, cfg, x), cache


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch, mesh=None, use_kernel="auto"):
    """Full-sequence forward returning logits (the cache is built by the
    decode path, as in the reference)."""
    return forward(params, cfg, batch, mesh=mesh, use_kernel=use_kernel)[0]
