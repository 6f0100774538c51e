"""Sharding rules: parameter specs, cache and batch specs, and the DTensor
placements they give.

Counterpart of `repro.parallel.sharding`. A spec is a tuple with one entry
per tensor dimension: None (replicated), a mesh axis name, or a tuple of
axis names (the dimension sharded over their product), as the reference's
``PartitionSpec``; ``()`` is a replicated leaf. Mesh axes: ('data',
'model') single pod; ('pod', 'data', 'model') multi-pod. Batch shards on
('pod', 'data') (together: DP); weights on 'model' (TP/EP):

  attention q/k/v on heads, o on heads (`launch.specs.mesh_adapt` pads
  head counts that do not divide, e.g. Arctic's 56) · FFN on d_ff · experts
  on the expert axis · embeddings on vocab, LM head on vocab ·
  norms/scalars replicated.

The parameter tree is the reference's pytree layout (`models.model.LM.tree`:
each block's leaves stacked over its stage's periods), so `param_specs`
gives the reference's spec leaf for leaf. The decode cache is the port's
own: a list of per-layer dicts (`models.model.init_cache`), with no period
axis, so `cache_specs` drops the reference's leading stacked dimension.

`placements` turns a spec into DTensor placements (``Shard(d)`` /
``Replicate()`` per mesh axis) and `shard_tree` places a tree of global
tensors on a mesh: each leaf becomes a DTensor whose local tensor is this
rank's block, a view of the global leaf (never a copy).
"""
from __future__ import annotations

import math

import torch

from ..optim.optimizers import OptState


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name)) if name in mesh.mesh_dim_names else 1


def dp_size(mesh) -> int:
    return math.prod(axis_size(mesh, a) for a in data_axes(mesh))


def _entry(axes: tuple):
    """A spec entry of ``axes``: one name alone, as ``PartitionSpec``
    normalises it."""
    return axes[0] if len(axes) == 1 else axes


def batch_spec(mesh) -> tuple:
    return (_entry(data_axes(mesh)),)


_RULES = {
    # embed is sharded on VOCAB: with tied embeddings the head's logits are
    # then vocab-sharded, never a replicated (B, S, V)
    "embed": lambda nd: ("model", None),
    "head": lambda nd: (None, "model"),
    "frontend_proj": lambda nd: (None, "model"),
    # attention (3-D) and RWKV projections (2-D) share names
    "wq": lambda nd: (None, "model", None) if nd == 3 else (None, "model"),
    "wk": lambda nd: (None, "model", None) if nd == 3 else (None, "model"),
    "wv": lambda nd: (None, "model", None) if nd == 3 else (None, "model"),
    "wo": lambda nd: ("model", None, None) if nd == 3 else ("model", None),
    "bq": lambda nd: ("model", None),
    "bk": lambda nd: ("model", None),
    "bv": lambda nd: ("model", None),
    # MLA
    "w_dq": lambda nd: (None, "model"),
    "w_uq": lambda nd: (None, "model", None),
    "w_dkv": lambda nd: (),
    "w_uk": lambda nd: (None, "model", None),
    "w_uv": lambda nd: (None, "model", None),
    # dense FFN (2-D) and expert stacks (3-D)
    "w_gate": lambda nd: (None, "model") if nd == 2 else ("model", None, None),
    "w_up": lambda nd: (None, "model") if nd == 2 else ("model", None, None),
    "w_down": lambda nd: ("model", None) if nd == 2 else ("model", None, None),
    "b_up": lambda nd: ("model",),
    "b_down": lambda nd: (),
    "router": lambda nd: (),
    # mamba
    "in_proj": lambda nd: (None, "model"),
    "conv_w": lambda nd: (None, "model"),
    "conv_b": lambda nd: ("model",),
    "x_proj": lambda nd: ("model", None),
    "dt_proj": lambda nd: (None, "model"),
    "dt_bias": lambda nd: ("model",),
    "A_log": lambda nd: ("model", None),
    "D": lambda nd: ("model",),
    "out_proj": lambda nd: ("model", None),
    # rwkv
    "wr": lambda nd: (None, "model"),
    "wk_r": lambda nd: (None, "model"),
    "wg": lambda nd: (None, "model"),
    "w_lora_a": lambda nd: (),
    "w_lora_b": lambda nd: (None, "model"),
    "w_bias": lambda nd: ("model",),
    "u": lambda nd: ("model", None),
    "ln_g": lambda nd: ("model",),
    "ln_b": lambda nd: ("model",),
    "ck": lambda nd: (None, "model"),
    "cv": lambda nd: ("model", None),
    "cr": lambda nd: (None, "model"),
    "mu": lambda nd: (),
    "mu_c": lambda nd: (),
}


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *matching nodes of rest)`` over the leaves of a tree
    of dicts, lists and NamedTuples (a spec tuple in ``rest`` is a leaf);
    None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, *(getattr(r, f) for r in rest), path=path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, list):
        return [_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _spec_for_leaf(path, leaf) -> tuple:
    names = [p for p in path if isinstance(p, str)]
    name = names[-1] if names else ""
    nd = leaf.ndim
    in_stage = "stages" in names
    rule = _RULES.get(name)
    spec = () if rule is None else rule(nd - (1 if in_stage else 0))
    if in_stage:                          # the stacked period dimension
        spec = (None,) + tuple(spec)
    return spec


def param_specs(params):
    """The spec tree of a parameter tree (works on meta tensors)."""
    tree = getattr(params, "tree", params)
    return _map_with_path(_spec_for_leaf, tree)


def _entry_size(mesh, entry) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axis_size(mesh, a) for a in axes)


def sanitize_spec(mesh, spec: tuple, shape) -> tuple:
    """``spec`` with every entry whose dimension does not divide its mesh
    axes dropped to None (e.g. HuBERT's 504-class head on 16)."""
    dims = list(spec)
    for i, ax in enumerate(dims):
        if ax is not None and i < len(shape) and shape[i] % _entry_size(mesh, ax):
            dims[i] = None
    return tuple(dims)


def sanitize_specs(mesh, specs, tree):
    """`sanitize_spec` leaf by leaf."""
    return _map_with_path(lambda _p, leaf, spec: sanitize_spec(mesh, spec, leaf.shape), tree, specs)


def opt_state_specs(opt_state, params):
    """AdamW mu/nu mirror the param specs; step is replicated."""
    pspecs = param_specs(params)
    return OptState(step=(), mu=None if opt_state.mu is None else pspecs,
                    nu=None if opt_state.nu is None else pspecs)


def batch_specs(mesh, batch):
    """Shard the leading (batch) dim of every batch leaf on ('pod', 'data');
    leaves whose batch dim the DP size does not divide (long_500k's batch
    of 1) are replicated."""
    dp, n = _entry(data_axes(mesh)), dp_size(mesh)

    def leaf(_path, x):
        if x.ndim == 0 or x.shape[0] % n:
            return ()
        return (dp,) + (None,) * (x.ndim - 1)

    return _map_with_path(leaf, batch)


# ---------------------------------------------------------------------------
# KV-cache / recurrent-state sharding (one dict per layer, no period axis)
# ---------------------------------------------------------------------------

_CACHE_RULES = {
    "k": ("B", None, "model", None),
    "v": ("B", None, "model", None),
    "pos_tag": (None,),
    "c_kv": ("B", None, "model"),
    "k_rope": ("B", None, None),
    "conv": ("B", None, "model"),
    "h": ("B", "model", None),
    "shift": ("B", "model"),
    "shift_c": ("B", "model"),
    "wkv": ("B", "model", None, None),
}


def cache_specs(mesh, cache):
    """The spec tree of a decode cache (`models.model.init_cache`)."""
    dp, n = data_axes(mesh), dp_size(mesh)
    dp = _entry(dp) if dp else dp

    def leaf(path, x):
        rule = _CACHE_RULES.get(path[-1] if path else "")
        if rule is None:
            return ()
        return tuple((dp if dim % n == 0 and dp else None) if axis == "B" else axis
                     for axis, dim in zip(rule, x.shape))

    return _map_with_path(leaf, cache)


# ---------------------------------------------------------------------------
# placements and DTensors
# ---------------------------------------------------------------------------

def placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec``: per mesh axis, ``Shard(d)`` for the
    tensor dimension ``d`` whose entry names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def spec_of(x) -> tuple:
    """The spec of a DTensor (its placements read back), () for a tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return ()
    names = x.device_mesh.mesh_dim_names
    dims = [[] for _ in range(x.ndim)]
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d)) for d in dims)


def local_index(mesh, spec: tuple, shape) -> list[tuple[int, int]]:
    """(start, length) of this rank's block along each dimension."""
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        # mesh-axis order, outermost first (DTensor's order for a dimension
        # sharded over several axes)
        idx, size = 0, 1
        for i, name in enumerate(names):
            if name in axes:
                idx, size = idx * mesh.size(i) + coord[i], size * mesh.size(i)
        out.append((idx * (n // size), n // size))
    return out


def local_shape(mesh, spec: tuple, shape) -> tuple:
    return tuple(length for _, length in local_index(mesh, spec, shape))


def local_block(mesh, spec: tuple, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec``: a view."""
    for d, (start, length) in enumerate(local_index(mesh, spec, x.shape)):
        if length != x.shape[d]:
            x = x.narrow(d, start, length)
    return x


def to_dtensor(mesh, spec: tuple, local: torch.Tensor, shape=None):
    """A DTensor of this rank's block ``local`` of a leaf of global
    ``shape``; nothing is copied or communicated."""
    from torch.distributed.tensor import DTensor

    shape = tuple(local.shape) if shape is None else tuple(shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, placements(mesh, spec), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def shard_tree(mesh, specs, tree):
    """Place a tree of global tensors on ``mesh`` by ``specs`` (sanitized
    here): each leaf becomes a DTensor whose local tensor is this rank's
    block, a view of the leaf."""
    def leaf(_path, x, spec):
        spec = sanitize_spec(mesh, spec, x.shape)
        return to_dtensor(mesh, spec, local_block(mesh, spec, x), x.shape)

    return _map_with_path(leaf, tree, specs)


def constrain(x, mesh, spec: tuple):
    """The reference's sharding constraint on a DTensor: ``x`` redistributed
    to ``spec``'s placements (a collective where they differ)."""
    return x.redistribute(mesh, placements(mesh, sanitize_spec(mesh, spec, x.shape)))


def global_norm(leaves) -> torch.Tensor:
    """The L2 norm of a list of DTensors over the whole mesh: each leaf's
    local sum of squares (float32), summed over the mesh axes it is
    sharded on; an axis it is replicated on counts it once."""
    import torch.distributed._functional_collectives as funcol

    groups: dict = {}
    for g in leaves:
        dims = tuple(i for i, p in enumerate(g.placements) if p.is_shard())
        sq = torch.sum(torch.square(g.to_local().float()))
        groups[dims] = sq if dims not in groups else groups[dims] + sq
    total = 0.0
    for dims, sq in groups.items():
        mesh = leaves[0].device_mesh
        for i in dims:
            if mesh.size(i) > 1:
                sq = funcol.all_reduce(sq, "sum", (mesh, i))
                sq = sq.wait() if isinstance(sq, funcol.AsyncCollectiveTensor) else sq
        total = total + sq
    return torch.sqrt(total)
