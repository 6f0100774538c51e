"""Alg. A2: the FedSem resource-allocation algorithm (paper §IV-D).

Counterpart of `repro.core.allocator`. Alternates
  Step 1: given (P, X), solve P3(f, rho, T) in closed form (Theorem 1);
  Step 2: given (f, rho, T), solve P4 -> P5 for (P, X): the paper's SCA/KKT
          path (``inner="sca"``, Alg. A1) or the PGD solver (``inner="pgd"``);
for a fixed J_max and returns the trace. Afterwards X is hardened to binary,
powers are re-solved given the binary X, and (f, rho) re-derived, so the
reported allocation is feasible for the original P1.

`solve_batch` is the entry point. The reference vmaps `solve` over
scenarios and runs the three multi-start inits one after the other; here
both become one leading axis: row ``b * S + s`` is scenario b from start s,
so one eager pass solves every scenario and every start together. The
multi-start selection and every outer iteration's trace entry score all
rows with one launch of the `fedsem_objective` kernel (`core.scoring`).

Warm starts (`ExtraStart`, `refine_with_start`) lay out their candidates
the same way: row ``b * C + c`` is scenario b from candidate c, one more
eager pass per inner, scored together with the cold result in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .accuracy import AccuracyFn, default_accuracy
from .p3 import solve_p3
from .p5 import P5Config, r_min, solve_p5
from .pgd import PGDConfig, power_given_x, solve_p4_pgd
from .scoring import candidate_objectives, scenario_objective
from .system import _col, device_rate, objective
from .types import Allocation, SystemParams, Weights, tree_index, tree_map

INNERS = ("sca", "pgd", "auto")


class ExtraStart(NamedTuple):
    """Warm-start candidate(s) per scenario.

    ``f``/``P``/``X`` are a prior solution at the scenario's (padded) shape,
    e.g. a `repro_torch.serve.warmstart` cache hit, as tensors or numpy
    arrays. ``valid`` is a {0, 1} float: a scenario with ``valid == 0``
    carries placeholders and its candidate is excluded from the selection
    (its objective forced to +inf), so a batch can mix hits and misses.
    Batched use stacks a leading B axis on every leaf. A candidate axis may
    precede the per-scenario shapes (``valid``: (C,) for one scenario,
    (B, C) batched): every candidate is refined and competes in the same
    argmin, the top-k warm-start path.
    """

    f: object       # (N,) / (B, N), or (C, N) / (B, C, N)
    P: object       # (N, K) / (B, N, K), or (C, N, K) / (B, C, N, K)
    X: object       # like P
    valid: object   # scalar / (B,), or (C,) / (B, C), in {0., 1.}


class AllocatorConfig(NamedTuple):
    outer_iters: int = 6           # J_max of Alg. A2
    inner: str = "sca"             # "sca" (Alg. A1) | "pgd" (reference) |
                                   # "auto" (run both, keep the better)
    p5: P5Config = P5Config()
    pgd: PGDConfig = PGDConfig()
    #: score the multi-start selection and the per-iteration trace through
    #: the batched `kernels/fedsem_objective` path (the CUDA kernel for CUDA
    #: tensors, its plain version for CPU tensors); False keeps the plain
    #: `system.objective` path
    use_kernel_objective: bool = True


@dataclasses.dataclass(frozen=True)
class AllocatorResult:
    alloc: Allocation
    trace: torch.Tensor  # objective s^(i) per outer iteration, (..., outer_iters)


def equal_start(params: SystemParams):
    """Round-robin X, per-subcarrier power Pmax/|K_n|, f = fmax/2.

    Real subcarriers are round-robined over the real devices only, so a
    padded scenario starts from the assignment of its exact-shape twin.
    """
    dev = params.device
    k_idx = torch.arange(params.K, device=dev)
    n_real = torch.clamp_min(torch.sum(params.dev_mask, dim=-1), 1.0).to(torch.int64)
    owner = k_idx % n_real[..., None]                                   # (..., K)
    onehot = owner[..., None, :] == torch.arange(params.N, device=dev)[:, None]
    X = onehot.to(torch.float32) * params.sc_mask[..., None, :]
    n_sc = torch.sum(X, dim=-1, keepdim=True)
    P = X * params.p_max[..., None] / torch.clamp_min(n_sc, 1.0)
    f = params.f_max * 0.5
    return f, P, X


def low_power_start(params: SystemParams, margin: float = 1.5):
    """Round-robin X, powers sized to just clear the SemCom rate floor.

    The alternation has init-dependent fixed points; starting near the
    SemCom floor r = C/Tsc_max lets it settle at the low-energy one.
    """
    f, _, X = equal_start(params)
    n_sc = torch.clamp_min(torch.sum(X, dim=-1), 1.0)
    target = margin * params.C / params.t_sc_max             # rho=1 worst case
    per_sc = target / n_sc                                   # rate per subcarrier
    snr = torch.exp2(per_sc / params.bbar) - 1.0
    P = X * (snr[..., None] * params.noise_sc / torch.clamp_min(params.g, 1e-18))
    # stay feasible: respect the per-device power budget
    scale = torch.clamp_max(params.p_max / torch.clamp_min(torch.sum(P, dim=-1), 1e-12), 1.0)
    P = P * scale[..., None]
    return f, P, X


def full_payload_start(
    params: SystemParams, weights: Weights, pgd_cfg: PGDConfig = PGDConfig()
):
    """(P, X) pre-optimised by PGD at rho = 1 (full SemCom payload), so the
    multi-start argmin dominates the comm-opt-only baseline."""
    f, P, X = equal_start(params)
    payload = params.D + params.C                       # rho = 1
    rmin = params.C / params.t_sc_max                   # SemCom deadline floor
    P, X = solve_p4_pgd(params, weights.kappa1, payload, rmin, P, X, pgd_cfg)
    return f, P, X


def repair_rate_floor(params: SystemParams, P, X, rmin, iters: int = 30):
    """Per-device multiplicative power rescale so r_n >= rmin_n (bisection).

    Devices that cannot reach rmin even at Pmax are clamped to their budget.
    """
    p_tot = torch.clamp_min(torch.sum(P, dim=-1), 1e-12)
    s_cap = params.p_max / p_tot                       # max admissible scale

    def rate_at(s):
        return device_rate(params, P * s[..., None], X)

    need = rate_at(torch.ones_like(p_tot)) < rmin
    lo = torch.ones_like(p_tot)
    hi = torch.clamp_min(s_cap, 1.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = rate_at(mid) >= rmin
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    s = torch.where(need, torch.minimum(hi, s_cap), 1.0)
    return P * s[..., None]


def harden_x(X: torch.Tensor, N: int, K: int, dev_mask=None, sc_mask=None) -> torch.Tensor:
    """Binary X: argmax per subcarrier, then guarantee >= 1 subcarrier/device.

    Padded devices never win or steal a subcarrier, padded subcarriers stay
    unassigned, and ownership counts consider real subcarriers only. Ties go
    to the first index, as in the reference.
    """
    lead = tuple(X.shape[:-2])
    dev = X.device
    if dev_mask is None:
        dev_mask = torch.ones(lead + (N,), dtype=X.dtype, device=dev)
    if sc_mask is None:
        sc_mask = torch.ones(lead + (K,), dtype=X.dtype, device=dev)
    sc_mask = torch.broadcast_to(sc_mask, lead + (K,))
    dev_mask = torch.broadcast_to(dev_mask, lead + (N,))
    assign = torch.argmax(
        torch.where(dev_mask[..., :, None] > 0.0, X, -torch.inf), dim=-2
    )                                                                    # (..., K)
    for n in range(N):
        counts = torch.zeros(lead + (N,), dtype=X.dtype, device=dev).scatter_add(
            -1, assign, sc_mask
        )                                                      # real subcarriers
        need = (counts[..., n] < 0.5) & (dev_mask[..., n] > 0.0)
        # only steal real subcarriers from devices that own more than one
        donor_ok = (torch.gather(counts, -1, assign) > 1.5) & (sc_mask > 0.0)
        score = torch.where(donor_ok, X[..., n, :], -torch.inf)
        k_star = torch.argmax(score, dim=-1, keepdim=True)
        assign = torch.where(need[..., None], assign.scatter(-1, k_star, n), assign)
    onehot = assign[..., None, :] == torch.arange(N, device=dev)[:, None]
    return onehot.to(X.dtype) * sc_mask[..., None, :]


def _solve_from(
    params: SystemParams,
    weights: Weights,
    cfg: AllocatorConfig,
    acc: AccuracyFn,
    start,
) -> AllocatorResult:
    """One Alg. A2 run from a given (f, P, X) start, for every row at once
    (Theorem 1 re-derives f, so the start's f is not read)."""
    _, P, X = start
    trace = []
    for _ in range(cfg.outer_iters):
        p3 = solve_p3(params, weights, P, X, acc)            # Step 1 (Theorem 1)
        payload = params.D + _col(p3.rho) * params.C
        rmin = r_min(params, p3.rho, p3.T, p3.f)
        if cfg.inner == "sca":                               # Step 2 (Alg. A1)
            sol = solve_p5(params, weights, p3.rho, p3.T, p3.f, P, X, cfg.p5)
            P_new, X_new = sol.P, sol.X
        else:
            P_new, X_new = solve_p4_pgd(
                params, weights.kappa1, payload, rmin, P, X, cfg.pgd
            )
        P_new = repair_rate_floor(params, P_new, X_new, rmin)
        cand = Allocation(p3.f, P_new, X_new, p3.rho)
        trace.append(
            scenario_objective(params, weights, cand, acc)
            if cfg.use_kernel_objective
            else objective(params, weights, cand, acc)
        )
        P, X = P_new, X_new

    # ---- hardening: binary X, re-solved powers, re-derived (f, rho) ----
    Xb = harden_x(X, params.N, params.K, params.dev_mask, params.sc_mask)
    p3 = solve_p3(params, weights, P * Xb, Xb, acc)
    payload = params.D + _col(p3.rho) * params.C
    rmin = r_min(params, p3.rho, p3.T, p3.f)
    P = power_given_x(params, weights.kappa1, payload, rmin, Xb, P0=P * Xb)
    P = repair_rate_floor(params, P, Xb, rmin)
    p3 = solve_p3(params, weights, P, Xb, acc)               # final (f, rho, T)
    alloc = Allocation(f=p3.f, P=P, X=Xb, rho=p3.rho)
    lead = tuple(p3.rho.shape)
    trace = (
        torch.stack(trace, dim=-1) if trace
        else torch.zeros(lead + (0,), dtype=torch.float32, device=params.device)
    )
    return AllocatorResult(alloc=alloc, trace=trace)


def _multi_start(
    params: SystemParams, weights: Weights, cfg: AllocatorConfig, acc: AccuracyFn
) -> AllocatorResult:
    """The cold multi-start solve of a (B,) batch whose weights and accuracy
    leaves are (B,) tensors on the params' device."""
    B = params.g.shape[0]
    inners = ("sca", "pgd") if cfg.inner == "auto" else (cfg.inner,)
    starts = (
        equal_start(params),
        low_power_start(params),
        full_payload_start(params, weights, cfg.pgd),
    )
    S = len(starts)

    def rows(x, n):
        return x.repeat_interleave(n, dim=0)

    start = tuple(torch.stack(xs, dim=1).flatten(0, 1) for xs in zip(*starts))
    row_params, row_weights, row_acc = (
        tree_map(lambda x: rows(x, S), t) for t in (params, weights, acc)
    )
    results = [
        _solve_from(row_params, row_weights, cfg._replace(inner=inner), row_acc, start)
        for inner in inners
    ]
    # (B, C, ...) candidates in the reference's order: inner-major, then start
    cand = tree_map(
        lambda *xs: torch.cat([x.unflatten(0, (B, S)) for x in xs], dim=1), *results
    )
    objs = _score_candidates(params, weights, cand.alloc, acc, cfg)
    best = torch.argmin(objs, dim=1)                  # first occurrence on ties
    idx = torch.arange(B, device=params.device)
    return tree_map(lambda x: x[idx, best], cand)


def solve(
    params: SystemParams,
    weights: Weights,
    cfg: AllocatorConfig = AllocatorConfig(),
    accuracy: AccuracyFn | None = None,
    extra_start: ExtraStart | None = None,
) -> AllocatorResult:
    """Alg. A2 for one scenario: `solve_batch` on a batch of one.

    ``extra_start`` optionally adds warm-start candidate(s) (`ExtraStart`
    without the batch axis); `refine_with_start` has its guarantees."""
    extra = None
    if extra_start is not None:
        extra = ExtraStart(*(_as_float(x, params.device)[None] for x in extra_start))
    res = solve_batch(
        tree_map(lambda x: x[None], params), weights, cfg, accuracy, extra_starts=extra
    )
    return tree_index(res, 0)


def _as_float(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or a numpy array (copied)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def sanitize_start(params: SystemParams, extra: ExtraStart):
    """Clamp an externally supplied (f, P, X) into the solver's domain.

    Warm starts come from outside the solver (a cache, a previous FL round,
    possibly another scenario under the same signature): non-finite entries
    become 0, f is clipped into [1e-6 f_max, f_max], P into [0, p_max] per
    entry, X into [0, 1], and padded rows and columns are zeroed, so an
    exact-shape entry padded into a bucket stays inert like the built-in
    starts. ``params`` and the leaves share their leading axes.
    """
    dev = params.device
    clean = lambda x: torch.nan_to_num(_as_float(x, dev), nan=0.0, posinf=0.0, neginf=0.0)
    f = torch.minimum(torch.maximum(clean(extra.f), 1e-6 * params.f_max), params.f_max)
    P = torch.minimum(torch.clamp_min(clean(extra.P), 0.0), params.p_max[..., None])
    X = torch.clamp(clean(extra.X), 0.0, 1.0)
    live = params.dev_mask[..., :, None] * params.sc_mask[..., None, :]
    return f, P * live, X * live


def refine_with_start(
    params: SystemParams,
    weights: Weights,
    cfg: AllocatorConfig,
    acc: AccuracyFn,
    extra: ExtraStart,
    base: AllocatorResult,
) -> AllocatorResult:
    """Fold warm-start candidates into an already-solved batch.

    ``params`` is batch-stacked (B scenarios), ``base`` their cold
    `solve_batch` result; ``weights`` and ``acc`` leaves are scalars or (B,).
    ``extra`` carries one candidate per scenario (``valid`` (B,)) or C of
    them (``valid`` (B, C)). Each candidate runs the full Alg. A2 pipeline
    under every inner the config races, as one eager pass over B x C rows
    per inner; then base and candidates are scored together (one kernel
    launch with ``cfg.use_kernel_objective``) in the reference's order:
    base first, then inner-major, then candidate.

    * **Dominance**: the selected objective is min(base, candidates), so a
      warm start can only help or tie; a garbage candidate scores +inf
      (not valid, or a non-finite objective) and loses.
    * **Cold equivalence**: with ``valid == 0`` every candidate of a row is
      masked and the first-occurrence ``argmin`` picks the base; selection
      is a gather over the stacked results, so that row is ``base`` bit for
      bit.
    """
    B = params.g.shape[0]
    dev = params.device
    valid = _as_float(extra.valid, dev)
    leaves = [_as_float(x, dev) for x in (extra.f, extra.P, extra.X)]
    if valid.ndim == 1:                  # one candidate: a candidate axis of 1
        valid, leaves = valid[:, None], [x[:, None] for x in leaves]
    C = valid.shape[1]
    weights, acc = (_per_scenario_tree(t, B, dev) for t in (weights, acc))
    inners = ("sca", "pgd") if cfg.inner == "auto" else (cfg.inner,)

    def rows(x):
        return x.repeat_interleave(C, dim=0)

    row_params, row_weights, row_acc = (tree_map(rows, t) for t in (params, weights, acc))
    start = sanitize_start(row_params, ExtraStart(*(x.flatten(0, 1) for x in leaves), None))
    results = [
        _solve_from(row_params, row_weights, cfg._replace(inner=inner), row_acc, start)
        for inner in inners
    ]
    cand = tree_map(
        lambda b, *xs: torch.cat([b[:, None]] + [x.unflatten(0, (B, C)) for x in xs], dim=1),
        base, *results,
    )
    objs = _score_candidates(params, weights, cand.alloc, acc, cfg)
    # candidates (every index > 0) compete only when their start was valid
    # and their objective is finite; the base is never masked
    valid_vec = torch.cat(
        [torch.ones((B, 1), device=dev), valid.repeat(1, len(inners))], dim=1
    )
    is_cand = torch.arange(valid_vec.shape[1], device=dev) > 0
    ok = (valid_vec > 0.0) & torch.isfinite(objs)
    objs = torch.where(is_cand & ~ok, torch.inf, objs)
    best = torch.argmin(objs, dim=1)                  # first occurrence on ties
    idx = torch.arange(B, device=dev)
    return tree_map(lambda x: x[idx, best], cand)


def _score_candidates(params, weights, allocs: Allocation, acc, cfg) -> torch.Tensor:
    """(B, C) objectives of C candidates per scenario: one kernel launch
    with ``cfg.use_kernel_objective``, else the plain `system.objective`."""
    if cfg.use_kernel_objective:
        return candidate_objectives(params, weights, allocs, acc)
    B, C = allocs.rho.shape
    rows = lambda x: x.repeat_interleave(C, dim=0)
    flat = tree_map(lambda x: x.flatten(0, 1), allocs)
    return objective(
        *(tree_map(rows, t) for t in (params, weights)), flat, tree_map(rows, acc),
    ).unflatten(0, (B, C))


def _check_batched(tree, b: int, what: str) -> None:
    for fld in dataclasses.fields(tree):
        shape = tuple(torch.as_tensor(getattr(tree, fld.name)).shape)
        if len(shape) < 1 or shape[0] != b:
            raise ValueError(
                f"solve_batch({what}_batched=True) requires every {what} leaf "
                f"to carry a leading batch axis of size B={b} matching "
                f"params_batch; leaf '{what}.{fld.name}' has shape {shape}"
            )


def _per_scenario_tree(tree, b: int, dev):
    """Every leaf of a weights / accuracy tree as a (B,) tensor on ``dev``."""
    return tree_map(
        lambda x: torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32).to(dev), (b,)),
        tree,
    )


def solve_batch(
    params_batch: SystemParams,
    weights: Weights,
    cfg: AllocatorConfig = AllocatorConfig(),
    accuracy: AccuracyFn | None = None,
    *,
    weights_batched: bool = False,
    acc_batched: bool = False,
    mesh=None,
    extra_starts: ExtraStart | None = None,
) -> AllocatorResult:
    """Batched Alg. A2: solve B scenarios together on their device.

    ``params_batch`` is batch-stacked (`stack_params`, or a scenario
    family's ``sample_batch``), ``g`` of shape (B, N, K). The result's
    leaves carry a leading B axis (`tree_index` picks one scenario).

    ``weights`` is broadcast to every scenario unless ``weights_batched``
    (leaves with a leading B axis, `stack_weights`); ``accuracy`` likewise
    unless ``acc_batched`` (`stack_accuracy`). Rows are independent, so a
    scenario's answer does not depend on what else is in the batch.

    ``extra_starts`` optionally injects warm-start candidate(s) per
    scenario (an `ExtraStart` with leading-B leaves, optionally a (B, C)
    candidate axis): the cold batch solves first, unchanged, then
    `refine_with_start` keeps the per-scenario better. ``None`` is exactly
    the cold solve.

    ``mesh`` (scenario sharding) is not ported yet and raises
    `NotImplementedError` (ROADMAP.md §1, item 9).
    """
    if mesh is not None:
        raise NotImplementedError(
            "scenario sharding (mesh=) is not ported yet: ROADMAP.md §1, item 9"
        )
    if cfg.inner not in INNERS:
        raise ValueError(f"AllocatorConfig.inner must be one of {INNERS}, got {cfg.inner!r}")
    if params_batch.g.ndim != 3:
        raise ValueError(
            "solve_batch expects batch-stacked params with g of shape "
            f"(B, N, K); got g.shape={tuple(params_batch.g.shape)}. "
            "Stack scenarios with stack_params()."
        )
    b = params_batch.g.shape[0]
    dev = params_batch.device
    acc = accuracy if accuracy is not None else default_accuracy(dev)
    if weights_batched:
        _check_batched(weights, b, "weights")
    if acc_batched:
        _check_batched(acc, b, "accuracy")
    if extra_starts is not None:
        v = tuple(np.shape(extra_starts.valid))
        if len(v) not in (1, 2) or v[0] != b:
            raise ValueError(
                "solve_batch(extra_starts=...) requires extra_starts.valid of "
                f"shape (B,) or (B, C) with B={b} matching params_batch; got "
                f"{v}. Stack per-scenario warm starts with a leading batch "
                "axis (repro_torch.serve.warmstart builds these from cache hits)."
            )

    with torch.no_grad():
        w, a = (_per_scenario_tree(t, b, dev) for t in (weights, acc))
        base = _multi_start(params_batch, w, cfg, a)
        if extra_starts is None:
            return base
        return refine_with_start(params_batch, w, cfg, a, extra_starts, base)
