"""Model assembly: embed -> layers -> final norm -> head; prefill and decode.

Counterpart of `repro.models.model` for ``attn``/``attn_local`` and
``mamba`` blocks with a dense FFN and for ``rwkv`` blocks (time mix and
channel mix), with the reference's stub frontends: audio (HuBERT) projects
``batch["frame_embeds"]`` (B, S, frontend_dim) through ``frontend_proj``
in place of the token embedding; vision (Pixtral) writes the projected
``batch["patch_embeds"]`` (B, n_patch, frontend_dim) over the embeddings of
the leading n_patch positions. The parameters are one tree, laid out as the
reference's parameter pytree: ``embed``, ``final_ln``, optional ``head``
((d, n_classes) for audio, else (d, vocab)), optional ``frontend_proj``
(frontend_dim, d), and ``stages[name]["b{j}"]``, each leaf of a block
stacked over the stage's periods, with the reference's parameter names
(``ln``, ``attn.wq``, ``ffn.w_gate``, ...). An `LM` holds that tree and
its layers, each a
`Block` of views of the stacked leaves, in the reference's order (stage by
stage, period by period, pattern position by pattern position). It is
built by `init_params` (random, from a `torch.Generator`) or by
`repro_torch.bridge.lm_params_from_numpy` (the reference's pytree). The
train step, `fl.run_fl` and `checkpoint.io` take the tree (``LM.tree``),
and a per-leaf rule on it (`fl.topk_sparsify`) sees the reference's leaves.

Entry points:
  * forward(params, cfg, batch)               -> (logits, aux)
  * loss_fn(params, cfg, batch)               -> scalar   (training)
  * prefill(params, cfg, batch)               -> logits
  * decode_step(params, cfg, token, pos, cache) -> (logits, cache)

A batch is `launch.specs.input_specs`'s layout: {"tokens", "labels"}, with
"patch_embeds" for vision; {"frame_embeds", "labels", "mask"} for audio.
`forward` and `loss_fn` take an `LM` or its tree; over a tree, gradients
reach the tree's leaves.

MoE and MLA layers, meshes and the configs the registry lists in
``NOT_PORTED`` are not ported yet and raise `NotImplementedError`
(ROADMAP.md §1) before anything is allocated: the published Jamba config,
with its experts, raises; its dense cut (``n_experts=0``) runs.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.registry import NOT_PORTED, canonical
from ..core.types import tree_leaves, tree_map
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rwk
from .config import ModelConfig
from .layers import cross_entropy, dense_init, dtype_of, rms_norm, softcap


class Block:
    """One layer: ``ln``, ``attn`` {wq, wk, wv, wo[, bq, bk, bv]}, optional
    ``post_ln``, ``ffn_ln``, ``ffn`` {w_gate, w_up, w_down | w_up, b_up,
    w_down, b_down}, optional ``post_ffn_ln``; a ``mamba`` layer has
    ``mamba`` {in_proj, conv_w, ...} in place of ``attn``; an ``rwkv`` layer
    has ``ln``, ``rwkv`` (time and channel mix), optional ``post_ln`` and
    ``ffn_ln``. Its tensors are views of the tree's stacked leaves."""

    def __init__(self, kind: str, p: dict):
        self.kind = kind
        for name, value in p.items():
            setattr(self, name, value)


class LM:
    """The parameter tree ``tree`` (see the module's docstring) and its
    views: ``embed`` (V, d), ``final_ln`` (d,), ``head`` (d, V) unless tied
    (else None), ``frontend_proj`` (frontend_dim, d) with a frontend (else
    None), and the ``layers``, each a `Block` over period ``period`` of its
    stage's block ``b{j}`` (`torch.unbind` along the period axis)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        kinds = layer_kinds(cfg)
        self.cfg, self.tree = cfg, tree
        self.embed, self.final_ln, self.head = tree["embed"], tree["final_ln"], tree.get("head")
        self.frontend_proj = tree.get("frontend_proj")
        pat, layers = cfg.pattern_len, []
        for name, n_periods, _moe in cfg.stages():
            blocks = [_unbind(tree["stages"][name][f"b{j}"], n_periods) for j in range(pat)]
            layers += [blocks[j][period] for period in range(n_periods) for j in range(pat)]
        self.layers = [Block(kind, p) for kind, p in zip(kinds, layers, strict=True)]

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _unbind(node, n: int) -> list:
    """A block's stacked leaves (n, ...) -> n per-period dicts of views."""
    if isinstance(node, dict):
        parts = {k: _unbind(v, n) for k, v in node.items()}
        return [{k: parts[k][i] for k in node} for i in range(n)]
    if node.shape[0] != n:
        raise ValueError(f"a stacked leaf of {node.shape[0]} periods, the stage has {n}")
    return list(node.unbind(0))


def check_ported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` for what the port does not run yet."""
    if cfg.use_mla or cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE/MLA layers are not ported yet: ROADMAP.md §1, item 12")
    arch = canonical(cfg.name)
    if arch in NOT_PORTED:
        raise NotImplementedError(f"{cfg.name} is not ported yet: ROADMAP.md §1, {NOT_PORTED[arch]}")
    for kind in cfg.block_pattern:
        if kind not in ("attn", "attn_local", "mamba", "rwkv"):
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")


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
    """Random parameters of the reference's law, on the generator's device:
    drawn layer by layer in the reference's order, each layer written into
    its period of the stacked leaves (so init holds one layer beyond the
    tree)."""
    layer_kinds(cfg)                          # raises for what is not ported, before allocating
    dt = dtype_of(cfg)
    d = cfg.d_model
    tree = {"embed": dense_init(generator, (cfg.vocab, d), scale=0.02, dtype=dt)}
    out_dim = cfg.n_classes if cfg.arch_type == "audio" else cfg.vocab
    head = None if cfg.tie_embeddings else dense_init(generator, (d, out_dim), dtype=dt)
    if cfg.frontend is not None:
        tree["frontend_proj"] = dense_init(generator, (cfg.frontend_dim, d), dtype=dt)
    stages = {}
    for name, n_periods, _moe in cfg.stages():
        blocks = [None] * cfg.pattern_len
        for period in range(n_periods):
            for j, kind in enumerate(cfg.block_pattern):
                p = _init_block(generator, cfg, kind)
                if blocks[j] is None:
                    blocks[j] = tree_map(lambda x: x.new_empty((n_periods, *x.shape)), p)
                for dst, src in zip(tree_leaves(blocks[j]), tree_leaves(p), strict=True):
                    dst[period].copy_(src)
        stages[name] = {f"b{j}": block for j, block in enumerate(blocks)}
    tree["final_ln"] = torch.zeros((d,), dtype=dt, device=generator.device)
    if head is not None:
        tree["head"] = head
    tree["stages"] = stages
    return LM(cfg, tree)


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


def _project(x, w):
    """einsum("bsf,fd->bsd") in the promoted type of the two, as the
    reference's einsum promotes (bf16 embeddings into a float32 model)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _embed(params: LM, cfg, batch):
    if cfg.frontend == "audio":
        x = _project(batch["frame_embeds"], params.frontend_proj).to(dtype_of(cfg))
    else:
        x = params.embed[batch["tokens"]]
        if cfg.frontend == "vision":
            pe = _project(batch["patch_embeds"], params.frontend_proj)
            x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
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
        raise NotImplementedError("meshes (sharded models) are not ported yet: ROADMAP.md §1, item 11b")


def _run_layers(params: LM, cfg, x, positions, use_kernel, remat):
    """The layers, one period (``pattern_len`` layers) at a time. With
    ``remat`` under grad mode each period is recomputed in the backward pass
    (the reference's jax.checkpoint of its scanned period): only the
    residual stream between periods is kept."""
    layers = list(params.layers)
    period = cfg.pattern_len
    for i in range(0, len(layers), period):
        def period_fn(x, blocks=layers[i:i + period]):
            for blk in blocks:
                x = _apply_block(blk, cfg, x, positions, use_kernel)
            return x

        if remat and torch.is_grad_enabled():
            x = checkpoint(period_fn, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = period_fn(x)
    return x


def forward(params, cfg: ModelConfig, batch, mesh=None, use_kernel="auto", remat=True):
    """Logits (B, S, V) of ``batch`` (the module's layout; V is n_classes
    for audio), and the auxiliary loss (0 without MoE). ``params``: an `LM`
    or its tree (``LM.tree``).
    ``use_kernel`` picks the route of the attention, the WKV recurrence and
    the selective scan: "auto" (the CUDA kernels iff on a card), True (the
    kernels; CPU tensors raise) or False (the plain versions). The kernels
    are forward only: under grad mode with trainable leaves they raise, so
    a differentiated forward takes ``use_kernel=False``. ``remat``: see
    `_run_layers` (no effect without grad mode)."""
    _no_mesh(mesh)
    if not isinstance(params, LM):
        params = LM(cfg, params)
    x, positions = _embed(params, cfg, batch)
    x = _run_layers(params, cfg, x, positions, use_kernel, remat)
    return _head(params, cfg, x), 0.0


def loss_fn(params, cfg: ModelConfig, batch, mesh=None, use_kernel=False, remat=True):
    """Mean token cross-entropy of ``batch``'s ``labels`` (B, S) (labels < 0
    ignored; for audio, so are the positions where ``batch["mask"]`` is
    False), with the reference's defaults: the plain
    sequence mixers (the kernels have no backward pass) and remat. The
    reference's MoE auxiliary term is unreachable (`check_ported` raises for
    experts); a mesh raises."""
    _no_mesh(mesh)
    logits, _aux = forward(params, cfg, batch, mesh, use_kernel, remat)
    mask = batch.get("mask") if cfg.arch_type == "audio" else None
    return cross_entropy(logits, batch["labels"], mask=mask)


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
    in place and returns (logits (B, 1, V), cache). The token embedding is
    looked up whatever the frontend, as in the reference (an encoder's
    serving skips decode: `launch.specs.shape_skip_reason`)."""
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
    return forward(params, cfg, batch, mesh=mesh, use_kernel=use_kernel, remat=False)[0]
