"""FedSem system model: OFDMA rates, FL/SemCom energy & delay, objective (P1).

Counterpart of `repro.core.system`. Every function takes tensors with any
leading batch axes and reduces over the trailing device / subcarrier axes
only; per-row scalars (``rho``, the weights, the accuracy fit) have the
batch shape. Equation numbers reference the paper.
"""
from __future__ import annotations

import torch

from .accuracy import AccuracyFn, default_accuracy
from .types import Allocation, SystemParams, Weights

_EPS = 1e-12
_LN2 = 0.6931471805599453


def _col(x):
    """Per-row scalar (...,) -> (..., 1), broadcastable over devices."""
    return torch.as_tensor(x).unsqueeze(-1)


def subcarrier_rate(params: SystemParams, P: torch.Tensor) -> torch.Tensor:
    """r_{n,k}(p) = Bbar log2(1 + p g / (N0 Bbar)).  Eq. (1).  (..., N, K)."""
    snr = P * params.g / params.noise_sc
    return params.bbar * torch.log1p(snr) / _LN2


def device_rate(params: SystemParams, P: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """r_n = sum_k x_{n,k} r_{n,k}.  Eq. (2).  (..., N)."""
    return torch.sum(X * subcarrier_rate(params, P), dim=-1)


def device_power(P: torch.Tensor) -> torch.Tensor:
    """p_n = sum_k p_{n,k}.  Eq. (3)."""
    return torch.sum(P, dim=-1)


def fl_tx_time(params: SystemParams, r: torch.Tensor) -> torch.Tensor:
    """tau_n = D_n / r_n.  Eq. (4)."""
    return params.D / torch.clamp_min(r, _EPS)


def fl_tx_energy(p_n: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """E^t_n = p_n tau_n.  Eq. (5)."""
    return p_n * tau


def comp_time(params: SystemParams, f: torch.Tensor) -> torch.Tensor:
    """t^c_n = eta c_n d_n / f_n.  Eq. (6)."""
    return params.eta * params.c * params.d / torch.clamp_min(f, _EPS)


def comp_energy(params: SystemParams, f: torch.Tensor) -> torch.Tensor:
    """E^c_n = xi eta c_n d_n f_n^2.  Eq. (7)."""
    return params.xi * params.eta * params.c * params.d * torch.square(f)


def semcom_time(params: SystemParams, rho, r: torch.Tensor) -> torch.Tensor:
    """T^sc_n = rho C_n / r_n.  Eq. (10)."""
    return _col(rho) * params.C / torch.clamp_min(r, _EPS)


def semcom_energy(params: SystemParams, rho, p_n, r) -> torch.Tensor:
    """E^sc_n = p_n rho C_n / r_n.  Eq. (12)."""
    return p_n * semcom_time(params, rho, r)


def t_fl(params: SystemParams, alloc: Allocation) -> torch.Tensor:
    """T_FL = max_n (tau_n + t^c_n).  Eq. (8)."""
    r = device_rate(params, alloc.P, alloc.X)
    return torch.amax(fl_tx_time(params, r) + comp_time(params, alloc.f), dim=-1)


def energy_breakdown(params: SystemParams, alloc: Allocation):
    """Per-device (E^t, E^c, E^sc) tuple, each (..., N)."""
    r = device_rate(params, alloc.P, alloc.X)
    p_n = device_power(alloc.P)
    e_t = fl_tx_energy(p_n, fl_tx_time(params, r))
    e_c = comp_energy(params, alloc.f)
    e_sc = semcom_energy(params, alloc.rho, p_n, r)
    return e_t, e_c, e_sc


def objective(
    params: SystemParams,
    weights: Weights,
    alloc: Allocation,
    accuracy: AccuracyFn | None = None,
) -> torch.Tensor:
    """P1's objective, eq. (13): k1 Sum E_n + k2 T_FL - k3 Sum A_n(rho)."""
    acc = accuracy or default_accuracy(params.device)
    e_t, e_c, e_sc = energy_breakdown(params, alloc)
    total_e = torch.sum(e_t + e_c + e_sc, dim=-1)
    t = t_fl(params, alloc)
    # sum A_n(rho) over real devices only (padded ones have dev_mask 0)
    a = torch.sum(params.dev_mask * _col(acc.value(alloc.rho)), dim=-1)
    return weights.kappa1 * total_e + weights.kappa2 * t - weights.kappa3 * a


def report(params: SystemParams, weights: Weights, alloc: Allocation,
           accuracy: AccuracyFn | None = None) -> dict:
    """Per-row diagnostics used by benchmarks and the chip smoke run."""
    acc = accuracy or default_accuracy(params.device)
    e_t, e_c, e_sc = energy_breakdown(params, alloc)
    r = device_rate(params, alloc.P, alloc.X)
    return {
        "objective": objective(params, weights, alloc, acc),
        "energy_total": torch.sum(e_t + e_c + e_sc, dim=-1),
        "energy_fl_tx": torch.sum(e_t, dim=-1),
        "energy_fl_comp": torch.sum(e_c, dim=-1),
        "energy_semcom": torch.sum(e_sc, dim=-1),
        "t_fl": t_fl(params, alloc),
        "t_sc_max_dev": torch.amax(semcom_time(params, alloc.rho, r), dim=-1),
        "accuracy": acc.value(alloc.rho),
        "rho": alloc.rho,
        "min_rate": torch.amin(r, dim=-1),
    }


def feasible(params: SystemParams, alloc: Allocation, tol: float = 1e-4) -> torch.Tensor:
    """Per-row feasibility of constraints (13a)-(13g) (X binary at >= .5)."""
    xb = alloc.X > 0.5
    cap = torch.where(xb, params.p_max[..., None], 0.0) * (1 + tol) + _EPS
    ok_pow_sc = torch.all(torch.flatten(alloc.P <= cap, -2), dim=-1)
    ok_pow = torch.all(device_power(alloc.P) <= params.p_max * (1 + tol), dim=-1)
    ok_f = torch.all(alloc.f <= params.f_max * (1 + tol), dim=-1)
    ok_sc = torch.all(torch.sum(xb, dim=-2) <= 1, dim=-1)
    r = device_rate(params, alloc.P, alloc.X)
    ok_tsc = torch.all(
        semcom_time(params, alloc.rho, r) <= params.t_sc_max * (1 + tol), dim=-1
    )
    ok_rho = (alloc.rho <= 1.0 + tol) & (alloc.rho >= 0.0)
    return ok_pow_sc & ok_pow & ok_f & ok_sc & ok_tsc & ok_rho
