"""Model assembly: embed -> layers -> final norm -> head; prefill and decode.

Counterpart of `repro.models.model` for ``attn``/``attn_local`` and
``mamba`` blocks with a dense or MoE FFN and for ``rwkv`` blocks (time mix
and channel mix), with the reference's stub frontends: audio (HuBERT) projects
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

A layer's FFN is dense or MoE (`moe.moe_ffn`), as the reference's
`_stage_layout` decides: DeepSeek's dense prefix, Jamba's MoE on every
other layer of its period of 8. MoE layers return the router's
load-balance term, which `forward` sums (``aux``) and `loss_fn` adds as
0.01 * aux / n_layers. Attention is GQA, or DeepSeek's MLA with
``use_mla``. The configs the registry lists in ``NOT_PORTED`` raise
`NotImplementedError` (ROADMAP.md §1) before anything is allocated.

Every entry point takes ``mesh``, a `DeviceMesh` with the reference's axis
names (`launch.mesh`). The parameters are then DTensors placed by
`parallel.sharding.param_specs` (a plain tensor raises), the batch global
tensors or DTensors sharded on the data axes
(`parallel.sharding.batch_specs`), the decode cache DTensors placed by
`parallel.sharding.cache_specs`. Each rank computes on its local tensors:
its data shard of the batch (the whole batch where the data axes do not
divide it), its ``model`` shard of every weight (a layer's FSDP shards on
the data axes are gathered when the layer runs, and again by remat in the
backward pass: `_local_lm`), crossing ranks only through
`parallel.collectives` (module docstring there): the residual stream is
replicated over ``model`` between blocks (what the reference's
``_constrain_residual`` asks of GSPMD), the embedding and the head are
vocab-sharded and the head's logits stay so (the reference's ``_head``
constraint): `forward`, `prefill` and `decode_step` return them as a
DTensor, and `loss_fn` takes the vocab-sharded cross-entropy
(`_sharded_cross_entropy`) where the model axis divides the vocab, as the
reference does. Each kernel launches once per shard and layer.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..configs.registry import NOT_PORTED, canonical
from ..core.types import tree_map
from ..parallel import collectives as C
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rwk
from .config import ModelConfig
from .layers import ShapesOnly, constant, cross_entropy, dense_init, dtype_of, rms_norm, softcap


class Block:
    """One layer: ``ln``, ``attn`` {wq, wk, wv, wo[, bq, bk, bv]} (MLA:
    {w_dq, q_norm, w_uq, w_dkv, kv_norm, w_uk, w_uv, wo}), optional
    ``post_ln``, ``ffn_ln``, ``ffn`` {w_gate, w_up, w_down | w_up, b_up,
    w_down, b_down} (MoE: {router, w_gate, w_up, w_down} over the experts,
    optional ``shared`` and ``dense_res`` dense FFNs), optional
    ``post_ffn_ln``; a ``mamba`` layer has ``mamba`` {in_proj, conv_w, ...}
    in place of ``attn``; an ``rwkv`` layer has ``ln``, ``rwkv`` (time and
    channel mix), optional ``post_ln`` and ``ffn_ln``. ``is_moe``: whether
    ``ffn`` is routed. Its tensors are views of the tree's stacked leaves.
    ``gathers``: under a mesh, {leaf path: (mesh dims, dim)} of the leaves
    whose local tensors are FSDP shards, gathered when the block runs
    (`_gathered`)."""

    gathers: dict = {}

    def __init__(self, kind: str, is_moe: bool, p: dict):
        self.kind, self.is_moe = kind, is_moe
        self.parts = p
        for name, value in p.items():
            setattr(self, name, value)


class LM:
    """The parameter tree ``tree`` (see the module's docstring) and its
    views: ``embed`` (V, d), ``final_ln`` (d,), ``head`` (d, V) unless tied
    (else None), ``frontend_proj`` (frontend_dim, d) with a frontend (else
    None), and the ``layers``, each a `Block` over period ``period`` of its
    stage's block ``b{j}`` (`torch.unbind` along the period axis)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        self.cfg, self.tree = cfg, tree
        self.embed, self.final_ln, self.head = tree["embed"], tree["final_ln"], tree.get("head")
        self.frontend_proj = tree.get("frontend_proj")
        self.layers = []
        for name, n_periods, pat in stage_layout(cfg):
            blocks = [_unbind(tree["stages"][name][f"b{j}"], n_periods) for j in range(len(pat))]
            self.layers += [Block(kind, is_moe, blocks[j][period])
                            for period in range(n_periods) for j, (kind, is_moe) in enumerate(pat)]

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
    arch = canonical(cfg.name)
    if arch in NOT_PORTED:
        raise NotImplementedError(f"{cfg.name} is not ported yet: ROADMAP.md §1, {NOT_PORTED[arch]}")
    for kind in cfg.block_pattern:
        if kind not in ("attn", "attn_local", "mamba", "rwkv"):
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")


def stage_layout(cfg: ModelConfig) -> list:
    """[(stage name, n_periods, [(kind, is_moe) per pattern position])], the
    reference's `_stage_layout`: a layer's FFN is MoE where its stage has
    experts and `ModelConfig.is_moe_layer` holds at its position in the
    stage's first period (one pattern for every period), never in an
    ``rwkv`` layer (its channel mix is its FFN)."""
    check_ported(cfg)
    out, offset = [], 0
    for name, n_periods, moe_on in cfg.stages():
        pat = [(kind, moe_on and cfg.is_moe_layer(offset + j) and kind != "rwkv")
               for j, kind in enumerate(cfg.block_pattern)]
        if cfg.n_experts and moe_on and cfg.pattern_len % cfg.moe_every and cfg.moe_every != 1:
            raise ValueError(f"{cfg.name}: moe_every {cfg.moe_every} does not divide the "
                             f"pattern's {cfg.pattern_len} layers")
        out.append((name, n_periods, pat))
        offset += n_periods * cfg.pattern_len
    return out


def layer_layout(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """(kind, is_moe) of every layer, in the reference's order (the stages
    of `stage_layout`, period by period)."""
    return [layer for _name, n_periods, pat in stage_layout(cfg)
            for _ in range(n_periods) for layer in pat]


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The block kind of every layer, in the reference's order."""
    return [kind for kind, _moe in layer_layout(cfg)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ModelConfig, kind: str, is_moe: bool, out=None) -> dict:
    """One layer's parameters; with ``out`` (the layer's slot in the stacked
    tree: views, laid out as the result) each leaf is written there."""
    dt = dtype_of(cfg)
    d = cfg.d_model
    o = out or {}
    zeros = lambda name: constant((d,), 0.0, dt, generator.device, o.get(name))
    p = {"ln": zeros("ln")}
    if kind == "rwkv":
        p["rwkv"] = rwk.init_rwkv_params(generator, cfg, dt, o.get("rwkv"))
    elif kind == "mamba":
        p["mamba"] = mam.init_mamba_params(generator, cfg, dt, o.get("mamba"))
    elif cfg.use_mla:
        p["attn"] = attn.init_mla_params(generator, cfg, dt, o.get("attn"))
    else:
        p["attn"] = attn.init_attn_params(generator, cfg, dt, o.get("attn"))
    if cfg.post_norm:
        p["post_ln"] = zeros("post_ln")
    p["ffn_ln"] = zeros("ffn_ln")
    if kind == "rwkv":  # the channel mix, in ``rwkv``, is its FFN
        return p
    if is_moe:
        p["ffn"] = moe_mod.init_moe_params(generator, cfg, dt, o.get("ffn"))
    else:
        p["ffn"] = moe_mod.init_dense_ffn(generator, cfg, dt, out=o.get("ffn"))
    if cfg.post_norm:
        p["post_ffn_ln"] = zeros("post_ffn_ln")
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator) -> LM:
    """Random parameters of the reference's law, on the generator's device.
    The stacked tree is sized first (a shape pass on the meta device) and
    each layer, in the reference's order, is drawn straight into its period
    of the stacked leaves (an expert stack a run of experts at a time), so
    init holds nothing beside the tree but one draw's float32 temporaries."""
    layout = stage_layout(cfg)                # raises for what is not ported, before allocating
    dt = dtype_of(cfg)
    d = cfg.d_model
    dev = generator.device
    tree = {"embed": dense_init(generator, (cfg.vocab, d), scale=0.02, dtype=dt)}
    out_dim = cfg.n_classes if cfg.arch_type == "audio" else cfg.vocab
    head = None if cfg.tie_embeddings else dense_init(generator, (d, out_dim), dtype=dt)
    if cfg.frontend is not None:
        tree["frontend_proj"] = dense_init(generator, (cfg.frontend_dim, d), dtype=dt)
    stages = {}
    for name, n_periods, pat in layout:
        blocks = {f"b{j}": tree_map(lambda m: torch.empty((n_periods, *m.shape), dtype=m.dtype, device=dev),
                                    _init_block(ShapesOnly(), cfg, kind, is_moe))
                  for j, (kind, is_moe) in enumerate(pat)}
        for period in range(n_periods):
            for j, (kind, is_moe) in enumerate(pat):
                slot = tree_map(lambda x: x[period], blocks[f"b{j}"])
                _init_block(generator, cfg, kind, is_moe, out=slot)
        stages[name] = blocks
    tree["final_ln"] = torch.zeros((d,), dtype=dt, device=dev)
    if head is not None:
        tree["head"] = head
    tree["stages"] = stages
    return LM(cfg, tree)


# ---------------------------------------------------------------------------
# blocks, embeddings, head
# ---------------------------------------------------------------------------

def _block_window(cfg, kind):
    return cfg.sliding_window if kind == "attn_local" else None


def _ffn(blk: Block, cfg, x, par=None, whole=False):
    """The second residual of a non-``rwkv`` block: (x, the MoE's aux term,
    0.0 for a dense FFN). ``whole``: x is the whole batch on every data
    rank (a mesh whose data axes do not divide it)."""
    h = rms_norm(x, blk.ffn_ln, cfg.norm_eps)
    if blk.is_moe:
        out, aux = moe_mod.moe_ffn(blk.ffn, cfg, h, mesh=par, tokens_whole=whole)
    else:
        out, aux = moe_mod.dense_ffn(blk.ffn, cfg, h, par), 0.0
    if cfg.post_norm:
        out = rms_norm(out, blk.post_ffn_ln, cfg.norm_eps)
    return x + out, aux


def _post(blk: Block, cfg, inner):
    return rms_norm(inner, blk.post_ln, cfg.norm_eps) if cfg.post_norm else inner


def _channel_mix(blk: Block, cfg, x, state, par=None):
    """The second residual of an ``rwkv`` block; returns (x, channel state)."""
    out, c = rwk.channel_mix(blk.rwkv, cfg, rms_norm(x, blk.ffn_ln, cfg.norm_eps), state, par)
    return x + out, c


def _mixer(blk: Block, cfg, x, positions, use_kernel, par=None):
    """The first residual of a fresh sequence's ``attn``/``mamba`` layer:
    x + its attention or Mamba block (post-normed where the config says)."""
    h = rms_norm(x, blk.ln, cfg.norm_eps)
    if blk.kind == "mamba":
        # a fresh sequence from the zero state, its final state discarded
        inner, _ = mam.mamba_forward(blk.mamba, cfg, h, None, use_kernel=use_kernel, par=par)
    elif cfg.use_mla:           # the plain chunked attention, as the reference's MLA
        inner = attn.mla_forward(blk.attn, cfg, h, positions, par=par)
    else:
        inner = attn.gqa_forward(
            blk.attn, cfg, h, positions,
            window=_block_window(cfg, blk.kind), use_kernel=use_kernel, par=par,
        )
    return x + _post(blk, cfg, inner)


def _gathered(blk: Block, par) -> Block:
    """``blk`` with its FSDP leaves (``blk.gathers``) gathered over their
    data axes: all-gather forward, reduce-scatter backward, so each data
    rank's shard receives the whole batch's gradient."""
    if not blk.gathers:
        return blk
    p = dict(blk.parts)
    for path, (dims, dim) in blk.gathers.items():
        node = p
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = C.gather_data(node[path[-1]], par, dim, dims)
    return Block(blk.kind, blk.is_moe, p)


def _apply_block(blk: Block, cfg, x, positions, use_kernel, par=None, whole=False, layer=0):
    """One layer (index ``layer``) of a fresh sequence: (x, its aux term),
    its two residuals in the spans ``mixer`` and ``ffn``."""
    blk = _gathered(blk, par)
    with spans.span("mixer", layer=layer, kind=blk.kind):
        if blk.kind == "rwkv":
            # a fresh sequence: both mixes start from the zero state, and
            # their final states are discarded, as in the reference's forward
            h = rms_norm(x, blk.ln, cfg.norm_eps)
            inner, _ = rwk.time_mix(blk.rwkv, cfg, h, None, use_kernel=use_kernel, par=par)
            x = x + _post(blk, cfg, inner)
        else:
            x = _mixer(blk, cfg, x, positions, use_kernel, par)
    with spans.span("ffn", layer=layer, kind=blk.kind):
        if blk.kind == "rwkv":
            return _channel_mix(blk, cfg, x, None, par)[0], 0.0
        return _ffn(blk, cfg, x, par, whole)


def _project(x, w):
    """einsum("bsf,fd->bsd") in the promoted type of the two, as the
    reference's einsum promotes (bf16 embeddings into a float32 model)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _lookup(embed, tokens, cfg, par=None):
    """Token embeddings; a vocab-sharded table (under a mesh) looks up its
    own rows, zero elsewhere, and the shards are summed over ``model``."""
    V = embed.shape[0]
    if par is None or not par.sharded(V, cfg.vocab):
        return embed[tokens]
    idx = tokens - par.m * V
    ok = (idx >= 0) & (idx < V)
    return C.reduce(torch.where(ok[..., None], embed[torch.where(ok, idx, 0)], 0), par)


def _frontend(params: LM, cfg, embeds, par=None):
    """``embeds`` projected through ``frontend_proj``, whose d columns are
    gathered where a mesh shards them."""
    w = params.frontend_proj
    if par is not None and par.sharded(w.shape[1], cfg.d_model):
        return C.gather(_project(embeds, w), par)
    return _project(embeds, w)


def _embed(params: LM, cfg, batch, par=None):
    if cfg.frontend == "audio":
        x = _frontend(params, cfg, batch["frame_embeds"], par).to(dtype_of(cfg))
    else:
        x = _lookup(params.embed, batch["tokens"], cfg, par)
        if cfg.frontend == "vision":
            pe = _frontend(params, cfg, batch["patch_embeds"], par)
            x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return x, positions


def _out_dim(cfg) -> int:
    return cfg.n_classes if cfg.arch_type == "audio" else cfg.vocab


def _head(params: LM, cfg, x, par=None):
    """Logits; under a mesh a vocab-sharded head gives this rank's vocab
    shard of them (the reference's vocab-sharded logits)."""
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.head
    if par is not None and par.sharded(w.shape[1], _out_dim(cfg)):
        x = C.copy(x, par)
    logits = x @ w
    if cfg.final_softcap:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits


def _dp_size(mesh) -> int:
    """The product of the mesh's data axes (('pod', 'data'))."""
    return C.as_par(mesh).D


def _run_layers(params: LM, cfg, x, positions, use_kernel, remat, par=None, whole=False):
    """The layers, one period (``pattern_len`` layers) at a time: (x, the
    sum of the layers' aux terms). With ``remat`` under grad mode each
    period is recomputed in the backward pass (the reference's
    jax.checkpoint of its scanned period): only the residual stream between
    periods is kept."""
    layers = list(params.layers)
    period = cfg.pattern_len
    total = 0.0
    for i in range(0, len(layers), period):
        def period_fn(x, blocks=layers[i:i + period], first=i):
            aux = 0.0
            for j, blk in enumerate(blocks):
                x, a = _apply_block(blk, cfg, x, positions, use_kernel, par, whole, first + j)
                aux = aux + a
            return x, aux

        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(period_fn, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = period_fn(x)
        total = total + aux
    return x, total


# ---------------------------------------------------------------------------
# the mesh path's local tensors
# ---------------------------------------------------------------------------

def _is_2d_expert_stack(path, x) -> bool:
    return "ffn" in path and path[-1] in ("w_gate", "w_up", "w_down") and x.ndim == 4


def _compute_local(x, par, keep_data=False):
    """A parameter DTensor as this rank's compute tensor: its shards on the
    data axes (FSDP storage) gathered first unless ``keep_data``, then its
    local tensor, whose gradient is this data rank's share (Partial over
    the replicated data axes) and, on the data axes that shard it, the
    whole batch's gradient of this shard."""
    from torch.distributed.tensor import Partial, Replicate

    pl = list(x.placements)
    if not keep_data and any(pl[i].is_shard() for i in par.data_dims):
        pl = [Replicate() if i in par.data_dims else q for i, q in enumerate(pl)]
        x = x.redistribute(x.device_mesh, pl)
    grad = [Partial() if i in par.data_dims and not q.is_shard() else q for i, q in enumerate(pl)]
    return x.to_local(grad_placements=grad)


def _layer_gather(path, x, par):
    """(mesh dims, dim of one layer's tensor) along which a stacked layer
    leaf is FSDP-sharded, or None: where the data axes shard it on one
    dimension other than the period axis."""
    dims = {i: x.placements[i].dim for i in par.data_dims if x.placements[i].is_shard()}
    if path[0] != "stages" or len(set(dims.values())) != 1 or 0 in dims.values():
        return None
    return tuple(sorted(dims)), next(iter(dims.values())) - 1


def _local_lm(params, cfg, par) -> LM:
    """The `LM` of this rank's local tensors (`_compute_local`), from
    DTensor parameters (a plain tensor raises). A layer's FSDP shards stay
    local: the block gathers them when it runs (`Block.gathers`), and remat
    again in the backward pass, so a step holds one period's gathered
    weights, as the reference's scanned periods do. The other data-sharded
    leaves (embedding, head, a stack sharded on its period axis) are
    gathered here; the 2-D expert layout's stacks compute on their data
    shards."""
    from torch.distributed.tensor import DTensor

    from ..parallel import sharding as SH

    tree = params.tree if isinstance(params, LM) else params
    moe_2d = getattr(cfg, "moe_2d", False)
    gathers = {}

    def leaf(path, x):
        if not isinstance(x, DTensor):
            raise TypeError(f"under a mesh every parameter is a DTensor (parallel.sharding.shard_tree); "
                            f"{'.'.join(path)} is a {type(x).__name__}")
        if moe_2d and _is_2d_expert_stack(path, x):
            return _compute_local(x, par, keep_data=True)
        g = _layer_gather(path, x, par)
        if g is not None:
            gathers[path] = g
        return _compute_local(x, par, keep_data=g is not None)

    lm = LM(cfg, SH._map_with_path(leaf, tree))
    if gathers:
        layers = iter(lm.layers)
        for name, n_periods, pat in stage_layout(cfg):
            for _ in range(n_periods):
                for j in range(len(pat)):
                    next(layers).gathers = {p[3:]: g for p, g in gathers.items() if p[1:3] == (name, f"b{j}")}
    return lm


def _local_batch(batch, par):
    """(this rank's batch, whether it is the whole batch): DTensors give
    their local tensors; a global leaf (every rank holding the whole
    batch) its data shard (a view) where the data axes divide its batch,
    else the whole of it."""
    from torch.distributed.tensor import DTensor

    out, whole = {}, False
    for k, x in batch.items():
        if isinstance(x, DTensor):
            whole = whole or not any(x.placements[i].is_shard(0) for i in par.data_dims) and par.D > 1
            out[k] = x.to_local()
        elif x.ndim == 0 or x.shape[0] % par.D:
            whole = whole or par.D > 1
            out[k] = x
        else:
            out[k] = C.slice_data(x, par)
    return out, whole


def _as_dtensor(logits, cfg, par, whole):
    """Local logits (B_local, S, V_local) as the global DTensor they are a
    block of: batch-sharded on the data axes unless ``whole``,
    vocab-sharded on ``model`` where the head is."""
    from ..parallel import sharding as SH

    V = _out_dim(cfg)
    vocab = "model" if par.sharded(logits.shape[-1], V) else None
    data = None if whole else SH.data_axes(par.mesh) or None
    B = logits.shape[0] * (1 if whole else par.D)
    return SH.to_dtensor(par.mesh, (data, None, vocab), logits, (B, logits.shape[1], V))


def _forward_local(params, cfg, batch, par, use_kernel, remat):
    """(local logits, aux, local batch, whole) under a mesh."""
    lm = _local_lm(params, cfg, par)
    b, whole = _local_batch(batch, par)
    with spans.span("embed"):
        x, positions = _embed(lm, cfg, b, par)
    x, aux = _run_layers(lm, cfg, x, positions, use_kernel, remat, par, whole)
    with spans.span("head"):
        logits = _head(lm, cfg, x, par)
    return logits, aux, b, whole


def forward(params, cfg: ModelConfig, batch, mesh=None, use_kernel="auto", remat=True):
    """Logits (B, S, V) of ``batch`` (the module's layout; V is n_classes
    for audio), and the sum of the MoE layers' load-balance terms (0.0
    without MoE). ``params``: an `LM` or its tree (``LM.tree``).
    ``use_kernel`` picks the route of the GQA attention, the WKV recurrence
    and the selective scan: "auto" (the CUDA kernels iff on a card), True
    (the kernels; CPU tensors raise) or False (the plain versions); MLA
    always takes the plain chunked attention, as the reference's does. The
    kernels are forward only: under grad mode with trainable leaves they
    raise, so a differentiated forward takes ``use_kernel=False``.
    ``remat``: see `_run_layers` (no effect without grad mode). Under a
    mesh the logits are a DTensor (module docstring)."""
    par = C.as_par(mesh)
    if par is not None:
        logits, aux, _, whole = _forward_local(params, cfg, batch, par, use_kernel, remat)
        return _as_dtensor(logits, cfg, par, whole), aux
    if not isinstance(params, LM):
        params = LM(cfg, params)
    with spans.span("embed"):
        x, positions = _embed(params, cfg, batch)
    x, aux = _run_layers(params, cfg, x, positions, use_kernel, remat)
    with spans.span("head"):
        logits = _head(params, cfg, x)
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch, mesh=None, use_kernel=False, remat=True):
    """Mean token cross-entropy of ``batch``'s ``labels`` (B, S) (labels < 0
    ignored; for audio, so are the positions where ``batch["mask"]`` is
    False), plus 0.01 * aux / n_layers for a config with experts (the
    reference's MoE term), with the reference's defaults: the plain
    sequence mixers (the kernels have no backward pass) and remat. Under a
    mesh whose model axis divides the vocab the cross-entropy is
    `_sharded_cross_entropy`'s, else the plain one with its sums reduced
    over the data axes, as the reference chooses."""
    par = C.as_par(mesh)
    if par is None:
        logits, aux = forward(params, cfg, batch, None, use_kernel, remat)
        mask = batch.get("mask") if cfg.arch_type == "audio" else None
        loss = cross_entropy(logits, batch["labels"], mask=mask)
    else:
        logits, aux, b, _ = _forward_local(params, cfg, batch, par, use_kernel, remat)
        mask = b.get("mask") if cfg.arch_type == "audio" else None
        if par.model_dim is not None and _out_dim(cfg) % par.M == 0:
            loss = _ce_local(logits, b["labels"], mask, par)
        else:
            loss = _data_cross_entropy(logits, b["labels"], mask, par)
    if cfg.n_experts:
        loss = loss + 0.01 * aux / max(cfg.n_layers, 1)
    return loss


def _data_cross_entropy(logits, labels, mask, par):
    """`layers.cross_entropy` on whole-vocab logits, its two sums reduced
    over the data axes."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    valid = (labels >= 0) if mask is None else (mask & (labels >= 0))
    nll = torch.where(valid, logz - gold, 0.0)
    total = C.reduce(torch.sum(nll), par, par.data_dims)
    count = C.reduce(torch.sum(valid), par, par.data_dims)
    return total / torch.clamp_min(count, 1)


class _LogZ(torch.autograd.Function):
    """log sum exp over the whole vocab of vocab-sharded logits lg (..., V/M):
    the max shift (numerical stability only, no gradient) over the whole
    vocab, as the reference takes it outside its shard_map, each shard's
    sum of exponentials, their sum over ``model``; the gradient this
    shard's softmax, exp(lg - logz). On an axis of 1 it is
    `torch.logsumexp`'s arithmetic and gradient to the bit."""

    @staticmethod
    def forward(ctx, lg, par):
        m = C.max_model(torch.amax(lg, -1), par)
        m = torch.where(m.abs() == torch.inf, 0.0, m)
        logz = torch.log(C.reduce(torch.sum(torch.exp(lg - m[..., None]), -1), par)) + m
        ctx.save_for_backward(lg, logz)
        return logz

    @staticmethod
    def backward(ctx, g):
        lg, logz = ctx.saved_tensors
        return g[..., None] * torch.exp(lg - logz[..., None]), None


def _ce_local(lg, lb, mask, par):
    """`_sharded_cross_entropy` on this rank's blocks: lg (B_l, S, V/M)."""
    lg = lg.float()
    v_local = lg.shape[-1]
    logz = _LogZ.apply(lg, par)
    local = lb.long() - par.m * v_local
    in_shard = (local >= 0) & (local < v_local)
    # the gold logit of the shard that holds it (the reference sums a
    # one-hot product: the same float32 value), zero in the others
    picked = torch.gather(lg, -1, torch.where(in_shard, local, 0)[..., None])[..., 0]
    gold = C.reduce(torch.where(in_shard, picked, 0.0), par)
    valid = (lb >= 0) if mask is None else (mask & (lb >= 0))
    nll = torch.where(valid, logz - gold, 0.0)
    total = C.reduce(torch.sum(nll), par, par.data_dims)
    count = C.reduce(torch.sum(valid), par, par.data_dims)
    return total / torch.clamp_min(count, 1)


def _sharded_cross_entropy(logits, labels, mesh, mask=None):
    """CE with the vocab axis kept sharded end to end: each vocab shard
    reduces locally and only (B, S) statistics cross ranks (a sum over
    ``model``, then over the data axes). ``logits`` (B, S, V): a DTensor
    (its local block is used) or a global tensor (this rank's block of it
    under (data, None, 'model') is used); ``labels``/``mask`` likewise."""
    from torch.distributed.tensor import DTensor

    from ..parallel import sharding as SH

    par = C.as_par(mesh)
    dp = SH.data_axes(par.mesh) if logits.shape[0] % par.D == 0 else None
    block = lambda x, spec: x.to_local() if isinstance(x, DTensor) else \
        SH.local_block(par.mesh, SH.sanitize_spec(par.mesh, spec, x.shape), x)
    lg = block(logits, (dp or None, None, "model"))
    lb = block(labels, (dp or None, None))
    mk = None if mask is None else block(mask, (dp or None, None))
    return _ce_local(lg, lb, mk, par)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, mesh=None) -> list[dict]:
    """One cache per layer: a KV cache (`attention.init_kv_cache`; MLA: the
    latent cache, `attention.init_mla_cache`), for an ``rwkv`` layer its
    state {"shift", "wkv", "shift_c"} (`rwkv.init_rwkv_state`), for a
    ``mamba`` layer its state {"conv", "h"} (`mamba.init_mamba_state`).
    With ``mesh`` its leaves are DTensors placed by
    `parallel.sharding.cache_specs`, each rank allocating its block."""
    if mesh is not None:
        from ..parallel import sharding as SH

        meta = init_cache(cfg, batch, max_len, "meta")

        def leaf(path, x, spec):
            spec = SH.sanitize_spec(mesh, spec, x.shape)
            local = torch.full(SH.local_shape(mesh, spec, x.shape), -1 if path[-1] == "pos_tag" else 0,
                               dtype=x.dtype, device=device)
            return SH.to_dtensor(mesh, spec, local, x.shape)

        return SH._map_with_path(leaf, meta, SH.cache_specs(mesh, meta))
    dt = dtype_of(cfg)

    def one(kind):
        if kind == "rwkv":
            return rwk.init_rwkv_state(cfg, batch, dt, device)
        if kind == "mamba":
            return mam.init_mamba_state(cfg, batch, dt, device)
        if cfg.use_mla:
            return attn.init_mla_cache(cfg, batch, max_len, dt, device)
        return attn.init_kv_cache(cfg, batch, max_len, _block_window(cfg, kind), dt, device)

    return [one(kind) for kind in layer_kinds(cfg)]


def _decode_layers(params: LM, cfg, x, pos: int, cache, par=None, whole=False):
    """The layers of one decode step over per-layer caches of local tensors
    (updated in place; the recurrent states' entries are rebound)."""
    for blk, c in zip(params.layers, cache):
        blk = _gathered(blk, par)
        h = rms_norm(x, blk.ln, cfg.norm_eps)
        if blk.kind == "rwkv":
            # one step of the plain recurrence from the carried state
            inner, c_t = rwk.time_mix(blk.rwkv, cfg, h, c, par=par)
            x, c_c = _channel_mix(blk, cfg, x + _post(blk, cfg, inner), c, par)
            c.update(c_t, **c_c)
            continue
        if blk.kind == "mamba":
            # one step of the plain recurrence from the carried state
            inner, new = mam.mamba_forward(blk.mamba, cfg, h, c, par=par)
            c.update(new)
        elif cfg.use_mla:
            inner, _ = attn.mla_decode(blk.attn, cfg, h, pos, c, par=par)
        else:
            inner, _ = attn.gqa_decode(blk.attn, cfg, h, pos, c, window=_block_window(cfg, blk.kind),
                                       par=par)
        x, _ = _ffn(blk, cfg, x + _post(blk, cfg, inner), par, whole)
    return x


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, pos: int, cache, mesh=None):
    """token: (B, 1) int; pos: the position of every row. Updates ``cache``
    in place and returns (logits (B, 1, V), cache). The token embedding is
    looked up whatever the frontend, as in the reference (an encoder's
    serving skips decode: `launch.specs.shape_skip_reason`). A MoE layer
    routes the B tokens of the step (capacity from T = B). Under a mesh
    the cache's leaves are DTensors placed by
    `parallel.sharding.cache_specs` (`init_cache(mesh=)`; a plain tensor
    raises), the logits a DTensor."""
    par = C.as_par(mesh)
    if par is None:
        x = _lookup(params.embed, token, cfg)
        return _head(params, cfg, _decode_layers(params, cfg, x, pos, cache)), cache
    from torch.distributed.tensor import DTensor

    from ..parallel import sharding as SH

    lm = _local_lm(params, cfg, par)
    b, whole = _local_batch({"token": token}, par)
    def local_leaf(path, x):
        if not isinstance(x, DTensor):
            raise TypeError(f"under a mesh the cache's leaves are DTensors (init_cache(mesh=)); "
                            f"layer {path[0]}'s {path[-1]} is a {type(x).__name__}")
        return x.to_local()

    local = SH._map_with_path(local_leaf, cache)
    views = [dict(c) for c in local]
    x = _lookup(lm.embed, b["token"], cfg, par)
    x = _decode_layers(lm, cfg, x, pos, local, par, whole)
    for c, v in zip(local, views):            # a rebound state is written back
        for k, t in v.items():
            if c[k] is not t:
                t.copy_(c[k])
    return _as_dtensor(_head(lm, cfg, x, par), cfg, par, whole), cache


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, batch, mesh=None, use_kernel="auto"):
    """Full-sequence forward returning logits (the cache is built by the
    decode path, as in the reference); a DTensor under a mesh. One request
    of the spans (`repro_torch.spans`): ``prefill``, with its positions
    as ``tokens``, over ``embed``, each layer's ``mixer`` and ``ffn``, and
    ``head``; they time the card's stream, and keep host times under a mesh."""
    first = batch["tokens"] if "tokens" in batch else batch["frame_embeds"]
    n = first.shape[0] * first.shape[1]
    with spans.root("prefill", first if mesh is None else None, tokens=n):
        return forward(params, cfg, batch, mesh=mesh, use_kernel=use_kernel, remat=False)[0]
