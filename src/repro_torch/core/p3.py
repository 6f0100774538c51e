"""Closed-form solver for subproblem P3(f, rho, T): paper Theorem 1.

Counterpart of `repro.core.p3`. Given fixed (P, X):
  * rho* solves Delta(rho) = sum_n kappa1 p_n C_n / r_n - kappa3 sum_n A'(rho) = 0
    (eq. 20/24), clipped at rho_max = min(1, min_n Tsc_max r_n / C_n);
  * T# solves F(T) = sum_n 2 kappa1 xi (min(eta c d/(T - tau), fmax))^3 - kappa2 = 0
    (eq. 28) by bisection;
  * f*_n = min(eta c_n d_n / (T# - tau_n), fmax)   (eq. 29)
  * T*   = max_n tau_n + eta c_n d_n / f*_n        (eq. 30)

Every row of a batch bisects at once: the loops have fixed counts (60
bisection steps, 40 doublings) and update with `torch.where`, so nothing in
them waits for the device.
"""
from __future__ import annotations

import dataclasses

import torch

from .accuracy import AccuracyFn, default_accuracy
from .system import _col, comp_time, device_power, device_rate, fl_tx_time
from .types import SystemParams, Weights

_RHO_LO = 1e-4


@dataclasses.dataclass(frozen=True)
class P3Solution:
    f: torch.Tensor
    rho: torch.Tensor
    T: torch.Tensor


def _bisect(fn, lo, hi, iters: int = 60):
    """Per-row root of a monotone function on [lo, hi] (sign change assumed)."""
    f_lo = fn(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        same_side = torch.sign(fn(mid)) == torch.sign(f_lo)
        lo = torch.where(same_side, mid, lo)
        hi = torch.where(same_side, hi, mid)
    return 0.5 * (lo + hi)


def solve_rho(
    params: SystemParams,
    weights: Weights,
    r: torch.Tensor,
    p_n: torch.Tensor,
    accuracy: AccuracyFn,
) -> torch.Tensor:
    """Optimal compression rate, eq. (24)."""
    # marginal SemCom energy cost of rho (constant in rho)
    cost = torch.sum(
        _col(weights.kappa1) * p_n * params.C / torch.clamp_min(r, 1e-12), dim=-1
    )

    def delta(rho):
        # accuracy gain counts real devices only (padded ones have dev_mask 0)
        return cost - weights.kappa3 * torch.sum(
            params.dev_mask * _col(accuracy.deriv(rho)), dim=-1
        )

    # Delta is increasing in rho (A' decreasing). Root in [_RHO_LO, 1] if sign
    # change; else the optimum sits at the boundary with the right sign.
    lo = torch.full_like(cost, _RHO_LO)
    hi = torch.ones_like(cost)
    rho_hash = torch.where(
        delta(lo) >= 0.0,
        lo,
        torch.where(delta(hi) <= 0.0, hi, _bisect(delta, lo, hi)),
    )
    # padded devices have C = 0; the floor keeps their deadline ratio finite
    # and huge so they never bind rho_max
    rho_max = torch.clamp_max(
        torch.amin(
            params.t_sc_max * torch.clamp_min(r, 1e-12) / torch.clamp_min(params.C, 1e-30),
            dim=-1,
        ),
        1.0,
    )
    return torch.clamp(torch.minimum(rho_hash, rho_max), _RHO_LO, 1.0)


def solve_T(params: SystemParams, weights: Weights, tau: torch.Tensor) -> torch.Tensor:
    """Bisection on F(T) = sum 2 k1 xi f_n(T)^3 - k2 = 0 (eq. 28)."""
    eta_cd = params.eta * params.c * params.d

    def F(T):
        f = torch.minimum(eta_cd / torch.clamp_min(_col(T) - tau, 1e-9), params.f_max)
        return (
            torch.sum(2.0 * _col(weights.kappa1) * params.xi * f**3, dim=-1)
            - weights.kappa2
        )

    t_lo = torch.amax(tau + eta_cd / params.f_max, dim=-1)

    # grow hi until F < 0 (F -> -kappa2 < 0 as T -> inf)
    t_hi = t_lo * 2.0 + 1.0
    for _ in range(40):
        t_hi = torch.where(F(t_hi) > 0.0, t_hi * 2.0, t_hi)
    t_star = _bisect(F, t_lo, t_hi)
    # if even the smallest feasible T has F <= 0, energy always wins: T = t_lo
    return torch.where(F(t_lo) <= 0.0, t_lo, t_star)


def solve_p3(
    params: SystemParams,
    weights: Weights,
    P: torch.Tensor,
    X: torch.Tensor,
    accuracy: AccuracyFn | None = None,
) -> P3Solution:
    """Theorem 1: optimal (f, rho, T) given fixed (P, X)."""
    acc = accuracy or default_accuracy(params.device)
    r = device_rate(params, P, X)
    p_n = device_power(P)
    tau = fl_tx_time(params, r)

    rho = solve_rho(params, weights, r, p_n, acc)
    T_hash = solve_T(params, weights, tau)
    eta_cd = params.eta * params.c * params.d
    f = torch.minimum(eta_cd / torch.clamp_min(_col(T_hash) - tau, 1e-9), params.f_max)
    T = torch.amax(tau + comp_time(params, f), dim=-1)
    return P3Solution(f=f, rho=rho, T=T)
