"""Objective scoring routed through the batched `fedsem_objective` kernel.

Counterpart of `repro.core.scoring`. `system.objective` scores allocations
with plain torch; the allocator's multi-start selection (G candidates per
scenario), its per-iteration trace (one allocation per row) and the serving
flushes score through one call of `kernels.fedsem_objective.ops.
objective_grid_batch` instead: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors. With ``check_feasible=False`` the kernel evaluates
exactly eq. 13 with the same masked reductions as `system.objective`, so the
two agree to float32 round-off, and padded scenarios score like their
exact-shape twins.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import spans
from ..kernels.fedsem_objective import ops
from .accuracy import AccuracyFn, default_accuracy
from .system import device_rate
from .types import PARAM_FIELDS, Allocation, SystemParams, Weights


def _candidate_axis(params: SystemParams) -> SystemParams:
    """Insert a candidate axis in front of each leaf's own trailing axes."""
    return dataclasses.replace(params, **{
        name: getattr(params, name).unsqueeze(-3 if name == "g" else -2)
        for name in PARAM_FIELDS
    })


def _per_scenario(x, lead, device) -> torch.Tensor:
    """A weight / accuracy leaf (scalar or lead-shaped) -> (prod(lead),)."""
    return torch.broadcast_to(torch.as_tensor(x).to(device), lead).reshape(-1)


def candidate_objectives(
    params: SystemParams,
    weights: Weights,
    allocs: Allocation,
    accuracy: AccuracyFn | None = None,
    *,
    use_kernel: str | bool = "auto",
) -> torch.Tensor:
    """Score G candidate allocations per scenario -> (..., G) objectives.

    ``params`` is one scenario or a batch with leading axes ``lead``;
    ``allocs`` leaves carry ``lead`` and then a candidate axis G (``f``:
    (..., G, N), ``P``/``X``: (..., G, N, K), ``rho``: (..., G)). Weights and
    the accuracy fit are scalars or ``lead``-shaped. Rates are derived per
    candidate (eq. 2) and every score comes from one kernel call, with
    `system.objective` semantics (no feasibility masking).
    """
    dev = params.device
    acc = accuracy or default_accuracy(dev)
    lead = tuple(params.c.shape[:-1])
    G, N = allocs.f.shape[-2:]
    r = device_rate(_candidate_axis(params), allocs.P, allocs.X)     # (..., G, N)
    p_n = torch.sum(allocs.P, dim=-1)                               # (..., G, N)
    obj = ops.objective_grid_batch(
        allocs.f.reshape(-1, G, N), p_n.reshape(-1, G, N), r.reshape(-1, G, N),
        allocs.rho.reshape(-1, G),
        *(getattr(params, n).reshape(-1, N) for n in ("c", "d", "D", "C", "t_sc_max", "f_max")),
        *(_per_scenario(k, lead, dev) for k in (weights.kappa1, weights.kappa2, weights.kappa3)),
        xi=float(params.xi), eta=float(params.eta),
        accuracy_ab=(_per_scenario(acc.a, lead, dev), _per_scenario(acc.b, lead, dev)),
        dev_mask=params.dev_mask.reshape(-1, N),
        check_feasible=False,
        use_kernel=use_kernel,
    )
    return obj.reshape(lead + (G,))


def scenario_objective(
    params: SystemParams,
    weights: Weights,
    alloc: Allocation,
    accuracy: AccuracyFn | None = None,
    *,
    use_kernel: str | bool = "auto",
) -> torch.Tensor:
    """`system.objective` via the kernel path: one allocation per scenario
    (``params`` and ``alloc`` may share leading batch axes) -> (...)."""
    one = Allocation(
        f=alloc.f.unsqueeze(-2), P=alloc.P.unsqueeze(-3),
        X=alloc.X.unsqueeze(-3), rho=torch.as_tensor(alloc.rho).unsqueeze(-1),
    )
    return candidate_objectives(
        params, weights, one, accuracy, use_kernel=use_kernel
    )[..., 0]


def batch_objectives(
    params_batch: SystemParams,
    weights: Weights,
    allocs: Allocation,
    accuracy: AccuracyFn | None = None,
    *,
    weights_batched: bool = False,
    use_kernel: str | bool = "auto",
) -> torch.Tensor:
    """Score one allocation per scenario of a stacked batch -> (B,).

    ``weights`` is broadcast unless ``weights_batched`` (leaves with a
    leading B axis); ``accuracy`` is one fit or a `stack_accuracy` batch.
    The B scenarios land on the kernel's scenario axis with G = 1.
    """
    b = params_batch.g.shape[0]
    if weights_batched:
        for name in ("kappa1", "kappa2", "kappa3"):
            shape = tuple(getattr(weights, name).shape)
            if shape != (b,):
                raise ValueError(
                    f"batch_objectives(weights_batched=True): weights.{name} has "
                    f"shape {shape}, want ({b},)"
                )
    with spans.root("score", params_batch.device, rows=b):
        return scenario_objective(
            params_batch, weights, allocs, accuracy, use_kernel=use_kernel
        )
