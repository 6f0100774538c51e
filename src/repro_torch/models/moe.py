"""Mixture-of-Experts: a top-k router and sort-based capacity dispatch; the
dense FFN of a block (swiglu / GeGLU / gelu+bias).

Counterpart of `repro.models.moe`. Dispatch sorts the (token, expert)
assignments by expert (stable, so earlier tokens keep their slots), gives
each expert ``capacity`` slots and drops the rest, gathers the tokens into
an (E, C, d) block, runs every expert's SwiGLU as three batched products,
and combines the gated outputs back. The combine sums each token's
contributions in the reference's order (ascending expert, from zero, in
x's type) as a gather over the token's at most ``top_k`` slots, not a
scatter-add: a scatter with atomics would change bf16 sums from run to run.
The shared experts (DeepSeek-V3) and the dense residual (Arctic) are dense
FFNs added beside the routed ones.

Under a mesh, `moe_ffn` is the reference's expert-parallel layout: experts
on ``model`` (each rank runs `moe_ffn_local`'s ``expert_slice`` of its own
experts over its data shard's tokens: routing and capacity per data
shard), the partial outputs summed over ``model``, the load-balance term
averaged over the mesh; the shared experts and the dense residual are
d_ff-sharded dense FFNs whose partial sums join that sum. `moe_ffn_2d`
(the serving layout, ``cfg.moe_2d``): experts on ``model`` times each
expert's d_ff on the other axes, the tokens of the whole batch on every
rank, the partial outputs summed over every axis. Each token's slots keep
`_combine`'s fixed order; nothing is summed with atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as C

from .layers import constant, dense_init, gelu, gelu_mlp, swiglu


def init_moe_params(generator, cfg, dtype, out=None) -> dict:
    """The router (float32 whatever the model's type), the experts'
    (E, d, eff) / (E, eff, d) stacks, and the shared experts' and the dense
    residual's dense FFNs where the config has them; with ``out`` (their
    slots in a stacked tree, by name) written there, an expert stack a run
    of experts at a time (`layers.dense_init`)."""
    d = cfg.d_model
    eff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    o = out or {}
    normal = lambda name, shape, dt=dtype: dense_init(generator, shape, dtype=dt, out=o.get(name))
    p = {
        "router": normal("router", (d, E), torch.float32),
        "w_gate": normal("w_gate", (E, d, eff)),
        "w_up": normal("w_up", (E, d, eff)),
        "w_down": normal("w_down", (E, eff, d)),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_dense_ffn(generator, cfg, dtype, cfg.n_shared_experts * eff, o.get("shared"))
    if cfg.moe_dense_residual:
        p["dense_res"] = init_dense_ffn(generator, cfg, dtype, cfg.d_ff, o.get("dense_res"))
    return p


def init_dense_ffn(generator, cfg, dtype, d_ff=None, out=None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    o = out or {}
    normal = lambda name, shape: dense_init(generator, shape, dtype=dtype, out=o.get(name))
    if cfg.ffn_kind in ("swiglu", "geglu"):
        return {
            "w_gate": normal("w_gate", (d, ff)),
            "w_up": normal("w_up", (d, ff)),
            "w_down": normal("w_down", (ff, d)),
        }
    dev = generator.device
    return {
        "w_up": normal("w_up", (d, ff)),
        "b_up": constant((ff,), 0.0, dtype, dev, o.get("b_up")),
        "w_down": normal("w_down", (ff, d)),
        "b_down": constant((d,), 0.0, dtype, dev, o.get("b_down")),
    }


def dense_ffn(p, cfg, x, par=None, d_ff=None):
    """The dense FFN of ``p``. Under a mesh whose ``model`` axis splits its
    d_ff (``d_ff``: the whole width, cfg.d_ff by default) the replicated x
    enters each rank's columns and the partial sums are reduced; ``b_down``
    is added once, after the sum."""
    if par is not None and par.sharded(p["w_up"].shape[1], d_ff or cfg.d_ff):
        return _add_bias(p, C.reduce(_partial(p, cfg, C.copy(x, par)), par))
    return _dense(p, cfg, x)


def _partial(p, cfg, x):
    """A d_ff shard's share of the dense FFN: all of it but ``b_down``."""
    return _dense(p, cfg, x) if "w_gate" in p else gelu_mlp(x, p["w_up"], p["w_down"], p.get("b_up"))


def _add_bias(p, out):
    return out + p["b_down"] if "w_gate" not in p and p.get("b_down") is not None else out


def _dense(p, cfg, x):
    if "w_gate" in p:
        if cfg.ffn_kind == "geglu":  # gemma2: gelu-gated
            g = x @ p["w_gate"]
            u = x @ p["w_up"]
            return (gelu(g) * u) @ p["w_down"]
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return gelu_mlp(x, p["w_up"], p["w_down"], p.get("b_up"), p.get("b_down"))


def router_topk(router_w, x, top_k: int):
    """(weights (T, k) float32 renormalised over the k, expert ids (T, k),
    the Switch load-balance term E * sum_e (share routed first to e) * (mean
    probability of e)). Ties go to the lower expert id, as `jax.lax.top_k`'s
    do (`torch.topk` promises no order among equal values)."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)
    E = router_w.shape[-1]
    routed = _counts(ids[:, 0], E).float() / ids.shape[0]
    aux = E * torch.sum(routed * torch.mean(probs, dim=0))
    return w, ids, aux


def _counts(ids, n: int):
    """How many of ``ids`` name each of 0..n-1 (`torch.bincount` with
    ``minlength`` n, at a size that does not depend on the values, so that
    a trace on fake tensors can size it)."""
    return torch.zeros((n,), dtype=torch.long, device=ids.device).index_add_(0, ids, torch.ones_like(ids))


def _dispatch_tables(ids, weights, n_experts: int, capacity: int):
    """Sort-based dispatch: (T, k) assignments -> (E, C) tables (token_idx
    int32, gate float32), and each assignment's slot (T, k) int64 (E * C:
    dropped). An expert's assignments keep their (token, k) order, and those
    past its capacity are dropped; empty slots point at token 0 with gate 0."""
    T, k = ids.shape
    dev = ids.device
    flat_e = ids.reshape(-1)
    flat_w = weights.reshape(-1)
    flat_t = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)
    e_sorted, t_sorted, w_sorted = flat_e[order], flat_t[order], flat_w[order]

    counts = _counts(flat_e, n_experts)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - offsets[e_sorted]      # rank within expert
    keep = pos_in_e < capacity

    drop = n_experts * capacity
    slot = torch.where(keep, e_sorted * capacity + pos_in_e, drop)
    token_idx = torch.zeros((drop + 1,), dtype=torch.int32, device=dev).index_put(
        (slot,), t_sorted)[:-1].reshape(n_experts, capacity)
    gate = torch.zeros((drop + 1,), dtype=torch.float32, device=dev).index_put(
        (slot,), torch.where(keep, w_sorted, 0.0))[:-1].reshape(n_experts, capacity)
    slot_of = torch.empty_like(slot).index_put((order,), slot).reshape(T, k)
    return token_idx, gate, slot_of


def _expert_compute(p, x_ec):
    """x_ec: (E, C, d) -> (E, C, d) through each expert's SwiGLU."""
    g = torch.bmm(x_ec, p["w_gate"])
    u = torch.bmm(x_ec, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


def _combine(y_ec, slot_of, dtype):
    """Each token's sum of its kept slots' rows of y_ec (E, C, d), in
    ascending slot order (ascending expert: a token's k experts differ),
    from zero, rounded to ``dtype`` after every add: the reference's
    scatter-add order. Dropped assignments (slot E * C) add nothing."""
    d = y_ec.shape[-1]
    rows = torch.cat([y_ec.reshape(-1, d), y_ec.new_zeros((1, d))])
    picked = rows[torch.sort(slot_of, dim=-1).values]                  # (T, k, d)
    out = torch.zeros(picked.shape[::2], dtype=dtype, device=picked.device)
    for j in range(picked.shape[1]):
        out = out + picked[:, j]
    return out


def capacity_of(cfg, T: int, E: int, size: int | None = None) -> int:
    """Slots per expert for T tokens routed over E experts (the reference's
    arithmetic, in Python floats): capacity_factor * top_k * T / E, times
    ``size`` for a slice of ``size`` experts; at least top_k."""
    if size is None:
        return max(int(cfg.capacity_factor * cfg.top_k * T / E), cfg.top_k)
    return max(int(cfg.capacity_factor * cfg.top_k * T * size / E), cfg.top_k)


def moe_ffn_local(p, cfg, x, *, expert_slice=None, n_total_experts=None):
    """MoE over flat tokens x: (T, d) -> ((T, d), aux). Routing is over all
    experts; with ``expert_slice`` (lo, size) only those experts compute (one
    expert-parallel shard, whose ``p`` holds their stacks only: the others'
    assignments are dropped, and capacity scales by size / E)."""
    w, ids, aux = router_topk(p["router"], x, cfg.top_k)
    out = _routed(p, cfg, x, w, ids, expert_slice, n_total_experts or cfg.n_experts)
    if "shared" in p:
        out = out + dense_ffn(p["shared"], cfg, x)
    if "dense_res" in p:
        out = out + dense_ffn(p["dense_res"], cfg, x)
    return out, aux


def _routed(p, cfg, x, w, ids, expert_slice, E):
    """The routed experts' sum for every token (the experts of
    ``expert_slice`` only, if given)."""
    T, d = x.shape
    if expert_slice is not None:
        lo, size = expert_slice
        local = (ids >= lo) & (ids < lo + size)
        w = torch.where(local, w, 0.0)
        n_exp = size
        capacity = capacity_of(cfg, T, E, size)
        # one bucket past the slice takes the other experts' assignments
        token_idx, gate, slot_of = _dispatch_tables(
            torch.where(local, ids - lo, size), w, n_exp + 1, capacity)
        token_idx, gate = token_idx[:n_exp], gate[:n_exp]
        slot_of = torch.clamp_max(slot_of, n_exp * capacity)        # the extra bucket: dropped
    else:
        n_exp = E
        capacity = capacity_of(cfg, T, E)
        token_idx, gate, slot_of = _dispatch_tables(ids, w, n_exp, capacity)

    x_ec = x[token_idx]                                             # (E, C, d)
    y_ec = _expert_compute(p, x_ec) * gate[..., None].to(x.dtype)
    return _combine(y_ec, slot_of, x.dtype)


def _moe_sharded(p, cfg, x, par, dims, expert_slice):
    """One rank's routed experts over its tokens x (T, d), with the shared
    experts and the dense residual, summed over the mesh axes ``dims``.
    The replicated x and gates enter this rank's experts through
    `collectives.copy`, so their gradients are whole on every rank. A
    shared FFN whose d_ff the model axis splits is a partial sum too (on
    one data rank only where ``dims`` cross the data axes, whose ranks hold
    the same tokens); the partials cross ranks in one reduction, stacked,
    and are added after it in the reference's order (the routed sum, then
    each extra); an extra the model axis does not split is added whole."""
    w, ids, aux = router_topk(p["router"], x, cfg.top_k)
    xe, we = C.copy(x, par), C.copy(w, par)
    parts = [_routed(p, cfg, xe, we, ids, expert_slice, cfg.n_experts)]
    eff = cfg.moe_d_ff or cfg.d_ff
    widths = {"shared": cfg.n_shared_experts * eff, "dense_res": cfg.d_ff}
    extras = [(p[n], par.sharded(p[n]["w_up"].shape[1], widths[n])) for n in widths if n in p]
    owner = par.d == 0 or not set(par.data_dims) & set(dims)
    for q, split in extras:
        if split:
            parts.append(_partial(q, cfg, xe) if owner else torch.zeros_like(parts[0]))
    summed = C.reduce(torch.stack(parts), par, dims)
    out, k = summed[0], 1
    for q, split in extras:
        if split:
            out, k = _add_bias(q, out + summed[k]), k + 1
        else:
            out = out + _dense(q, cfg, x)
    return out, aux


def moe_ffn_2d(p, cfg, x, mesh, model_axis: str = "model"):
    """Serving layout: experts on 'model' x each expert's d_ff on the other
    axes (``p``: this rank's (E/M, d, eff/D) stacks); the whole batch's
    tokens on every rank (this rank's data shard of x (B, S, d) gathered,
    its slice of the output returned), the partial outputs summed over
    every axis and the aux averaged over the mesh."""
    par = C.as_par(mesh)
    if model_axis != "model":
        raise ValueError("the mesh's expert axis is 'model'")
    B, S, d = x.shape
    full = C.gather_data(x.reshape(-1, d), par)
    e_local = p["w_gate"].shape[0]
    out, aux = _moe_sharded(p, cfg, full, par, par.all_dims,
                            (par.m * e_local, e_local) if par.sharded(e_local, cfg.n_experts) else None)
    return C.slice_data(out, par).reshape(B, S, d), C.mean_data(aux, par)


def moe_ffn(p, cfg, x, mesh=None, model_axis: str = "model", tokens_whole: bool = False):
    """(B, S, d) MoE FFN -> ((B, S, d), aux); expert-parallel over
    ``model`` under a mesh (module docstring), where ``p`` holds this
    rank's experts and x its data shard of the tokens, or, with
    ``tokens_whole``, the whole batch (one the data axes do not divide).
    Tokens are routed as the reference shards them: per data shard, by
    blocks of the whole batch's tokens where the data axes divide them, all
    together otherwise; with a model axis of 1, all together."""
    B, S, d = x.shape
    flat = x.reshape(-1, d)
    par = C.as_par(mesh)
    if par is None:
        out, aux = moe_ffn_local(p, cfg, flat)
        return out.reshape(B, S, d), aux
    if model_axis != "model":
        raise ValueError("the mesh's expert axis is 'model'")
    if par.M == 1:                            # the reference's unsharded layer
        full = flat if tokens_whole else C.gather_data(flat, par)
        out, aux = moe_ffn_local(p, cfg, full)
        out = out if tokens_whole else C.slice_data(out, par)
        return out.reshape(B, S, d), C.mean_data(aux, par)
    if getattr(cfg, "moe_2d", False):
        if tokens_whole:
            raise ValueError("moe_ffn_2d takes a data-sharded batch")
        return moe_ffn_2d(p, cfg, x, par, model_axis)
    e_local = p["w_gate"].shape[0]
    if not par.sharded(e_local, cfg.n_experts):
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not split over a model axis of {par.M}")
    chunked = tokens_whole and par.D > 1 and (B * S) % par.D == 0
    if chunked:
        flat = C.slice_data(flat, par)
    out, aux = _moe_sharded(p, cfg, flat, par, par.model_dims(), (par.m * e_local, e_local))
    if chunked:
        out = C.gather_data(out, par)
    return out.reshape(B, S, d), C.mean_data(aux, par)
