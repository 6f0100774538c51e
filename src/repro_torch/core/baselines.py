"""The paper's four baselines (Section V-B).

Counterpart of `repro.core.baselines`, for one scenario or a batch (any
leading axes on the `SystemParams` leaves, as in `core.system`). What the
reference takes as a JAX key, these take as an int seed or a
`torch.Generator` on the scenario's device (`scenarios.base.generator`).

* Equal Allocation          — round-robin subcarriers, equal power, f = 1 GHz,
                              rho = 1.
* Communication Opt. Only   — optimise (P, X) only (PGD); f random in
                              [0.5, 1.5] GHz, rho = 1.
* Computation Opt. Only     — optimise f only (Theorem-1 machinery); P at Pmax
                              spread over an equal X; rho = 1.
* Random Allocation         — random owner per subcarrier and random power
                              within Pmax; f = 0.1 f_max (below); rho = 1.
"""
from __future__ import annotations

import torch

from ..scenarios.base import generator
from .p3 import solve_T
from .pgd import PGDConfig, solve_p4_pgd
from .system import _col, device_rate, fl_tx_time
from .types import Allocation, SystemParams, Weights


def _lead(params: SystemParams) -> tuple:
    return tuple(params.c.shape[:-1])


def _one_hot(owner: torch.Tensor, N: int) -> torch.Tensor:
    """(..., K) owner per subcarrier -> (..., N, K) float32 X."""
    dev_ids = torch.arange(N, device=owner.device)
    return (owner[..., None, :] == dev_ids[:, None]).to(torch.float32)


def _equal_x(params: SystemParams) -> torch.Tensor:
    owner = torch.arange(params.K, device=params.device) % params.N
    X = _one_hot(owner, params.N)
    return torch.broadcast_to(X, _lead(params) + X.shape).clone()


def _spread_power(params: SystemParams, X: torch.Tensor, frac: float = 1.0) -> torch.Tensor:
    n_sc = torch.sum(X, dim=-1, keepdim=True)
    return X * frac * params.p_max[..., None] / torch.clamp_min(n_sc, 1.0)


def _ones(params: SystemParams) -> torch.Tensor:
    return torch.ones(_lead(params), dtype=torch.float32, device=params.device)


def equal_allocation(params: SystemParams) -> Allocation:
    X = _equal_x(params)
    return Allocation(
        f=torch.full(_lead(params) + (params.N,), 1e9, device=params.device),
        P=_spread_power(params, X),
        X=X,
        rho=_ones(params),
    )


@torch.no_grad()
def comm_opt_only(
    params: SystemParams, weights: Weights, seed,
    cfg: PGDConfig = PGDConfig(),
) -> Allocation:
    """(P, X) by PGD at rho = 1 from the equal start, against the SemCom
    deadline only; ``weights.kappa1`` is a scalar or one per scenario."""
    gen = generator(seed, params.device)
    u = torch.rand(_lead(params) + (params.N,), generator=gen, device=params.device)
    f = 0.5e9 + (1.5e9 - 0.5e9) * u
    rho = _ones(params)
    payload = params.D + _col(rho) * params.C
    rmin = _col(rho) * params.C / params.t_sc_max       # only the SemCom deadline
    X0 = _equal_x(params)
    P0 = _spread_power(params, X0)
    P, X = solve_p4_pgd(params, weights.kappa1, payload, rmin, P0, X0, cfg)
    return Allocation(f=f, P=P, X=X, rho=rho)


def comp_opt_only(params: SystemParams, weights: Weights) -> Allocation:
    X = _equal_x(params)
    P = _spread_power(params, X)                      # P at Pmax (spread)
    tau = fl_tx_time(params, device_rate(params, P, X))
    T = solve_T(params, weights, tau)
    eta_cd = params.eta * params.c * params.d
    f = torch.minimum(eta_cd / torch.clamp_min(_col(T) - tau, 1e-9), params.f_max)
    return Allocation(f=f, P=P, X=X, rho=_ones(params))


def random_allocation(params: SystemParams, seed) -> Allocation:
    gen = generator(seed, params.device)
    lead, dev = _lead(params), params.device
    owner = torch.randint(0, params.N, lead + (params.K,), generator=gen, device=dev)
    X = _one_hot(owner, params.N)
    # random power, rescaled into the feasible region (13a)+(13b)
    raw = torch.rand(lead + (params.N, params.K), generator=gen, device=dev) * X
    scale = torch.clamp_max(
        params.p_max / torch.clamp_min(torch.sum(raw, dim=-1), 1e-12), 1.0
    )
    P = raw * scale[..., None]
    # The reference draws f with jax.random.uniform(k, (N,), minval=0.1e9)
    # and the default maxval=1.0, which JAX clamps to minval: every draw is
    # 1e8, so f is always 0.1 f_max (a fault of the reference, ROADMAP.md
    # §3). The port keeps that law, so the baseline is the same.
    f = torch.full(lead + (params.N,), 0.1e9, device=dev) * (params.f_max / 2e9) * 2.0
    f = torch.minimum(f, params.f_max)
    return Allocation(f=f, P=P, X=X, rho=_ones(params))
