"""Subproblem P5(P, X, sigma): SCA + quadratic transform + KKT primal-dual.

Counterpart of `repro.core.p5` (Alg. A1 / Theorem 2). Per outer iteration:

  1. update the quadratic-transform auxiliary y_n = 1 / (2 (sum_k p) sigma_n)
     (eq. 37) and the SCA linearisation point x_bar = X^(i-1);
  2. seek a KKT point of the inner problem by projected primal-dual gradient
     flow on the partial Lagrangian L2 (eq. 39): primal Adam descent on
     (P, X, sigma) with box projections, dual ascent on (beta, iota, lambda,
     nu >= 0);
  3. record h^(i) = kappa1 sum sigma - varsigma J(X).

Everything is nondimensionalised (rates in units of Bbar, payload in
seconds) as in the reference. Each row of a batch keeps its own reductions
(device means, penalty sums), and the gradient of the batch-summed
Lagrangian is each row's own. Clips that a gradient flows through are
max/min pairs, whose gradient splits ties 0.5/0.5 like JAX's ``jnp.clip``
(X sits exactly at 1.0 after a projection).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .pgd import _grad, _maximum
from .system import _LN2, _col, device_rate
from .types import SystemParams, Weights

_EPS = 1e-12


class P5Config(NamedTuple):
    outer_iters: int = 8           # I_max of Alg. A1
    inner_iters: int = 250         # primal-dual steps per outer iteration
    lr_primal: float = 0.05        # Adam on (P, X, sigma) (normalised vars)
    lr_dual: float = 0.15          # projected ascent on multipliers
    varsigma: float = 0.5          # binary penalty factor (vs kappa1*sigma ~ J)
    nu_min: float = 1e-5           # paper: nu_n > 0 strictly


@dataclasses.dataclass(frozen=True)
class P5Solution:
    P: torch.Tensor
    X: torch.Tensor
    sigma: torch.Tensor
    h: torch.Tensor  # objective trace (..., outer_iters)


def r_min(params: SystemParams, rho, T, f) -> torch.Tensor:
    """Combined rate floor: r_n >= max(rho C / Tsc_max, D / (T - t_c))  (§IV-B)."""
    t_c = params.eta * params.c * params.d / torch.clamp_min(f, _EPS)
    slack = torch.clamp_min(_col(T) - t_c, 1e-6)
    return torch.maximum(_col(rho) * params.C / params.t_sc_max, params.D / slack)


def _linear_cap(params: SystemParams, x, x_bar):
    """Linearised power cap of (35a): [x_bar^q + q x_bar^(q-1) (x - x_bar)] Pmax."""
    q = float(params.q)
    xb = torch.clamp(x_bar, 1e-3, 1.0)
    pmax = params.p_max[..., None]
    cap = (xb**q + q * xb ** (q - 1.0) * (x - xb)) * pmax
    return torch.minimum(_maximum(cap, 0.0), pmax)


def penalty_J(x, x_bar):
    """J(X) of eq. (34) per row (linear in x; -varsigma*J pushes x to {0,1})."""
    return torch.sum(
        (2.0 * x_bar - 1.0) * (x - x_bar) + x_bar * (x_bar - 1.0), dim=(-2, -1)
    )


def _adam(g, m, v, t, lr):
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * torch.square(g)
    mh = m / (1 - 0.9**t)
    vh = v / (1 - 0.999**t)
    return -lr * mh / (torch.sqrt(vh) + 1e-8), m, v


def _inner_primal_dual(params, weights, payload_nd, rmin_nd, y, x_bar, init, cfg):
    """Projected primal-dual gradient flow on L2 (eq. 39), nondimensional."""
    P, X, sigma = init
    g_nd = params.g / params.noise_sc          # SNR per watt, (..., N, K)
    pmax = params.p_max[..., None]
    k1 = weights.kappa1
    # padded devices/subcarriers are pinned to zero after every primal step
    m2 = params.dev_mask[..., :, None] * params.sc_mask[..., None, :]
    n_real = torch.clamp_min(torch.sum(params.dev_mask, dim=-1), 1.0)

    def dev_mean(x):
        # mean over real devices: padded placeholders must not skew the Adam
        # learning-rate scales
        return torch.sum(x * params.dev_mask, dim=-1) / n_real

    def rate_nd(P, X):
        return torch.sum(X * torch.log1p(P * g_nd), dim=-1) / _LN2   # r / Bbar

    def quad(P, sigma):
        p_sum = torch.sum(P, dim=-1)
        return torch.square(p_sum) * y + 1.0 / (4.0 * y * torch.square(_maximum(sigma, _EPS)))

    def lagrangian(P, X, sigma, beta, iota, lam, nu):
        r = rate_nd(P, X)
        return (
            k1 * torch.sum(sigma, dim=-1)
            - cfg.varsigma * penalty_J(X, x_bar)
            + torch.sum(beta * (torch.sum(X, dim=-2) - 1.0), dim=-1)
            + torch.sum(lam * (rmin_nd - r), dim=-1)
            + torch.sum(iota * (P - _linear_cap(params, X, x_bar)) / pmax, dim=(-2, -1))
            + torch.sum(nu * (quad(P, sigma) * payload_nd - r), dim=-1)
        )

    beta = torch.zeros_like(P[..., 0, :])
    iota = torch.zeros_like(P)
    lam = torch.full_like(sigma, 0.1)
    # nu scaled from interior stationarity (42): nu = 2 y k1 sigma^3/payload
    # (payload floored: padded devices carry payload 0 and their nu is inert)
    nu = torch.clamp_min(
        2.0 * y * _col(k1) * sigma**3 / torch.clamp_min(payload_nd, 1e-30), cfg.nu_min
    )
    mP, vP = torch.zeros_like(P), torch.zeros_like(P)
    mX, vX = torch.zeros_like(X), torch.zeros_like(X)
    mS, vS = torch.zeros_like(sigma), torch.zeros_like(sigma)
    lr_P = (cfg.lr_primal * dev_mean(params.p_max))[..., None, None]
    lr_dual = torch.full((), cfg.lr_dual, dtype=torch.float32, device=P.device)
    for i in torch.arange(cfg.inner_iters, dtype=torch.float32, device=P.device):
        t = i + 1.0
        gP, gX, gS = (
            torch.nan_to_num(g, nan=0.0, posinf=1e6, neginf=-1e6)
            for g in _grad(
                lambda P_, X_, S_: lagrangian(P_, X_, S_, beta, iota, lam, nu),
                P, X, sigma,
            )
        )
        # normalise primal gradients to their variable scales
        lr_S = (cfg.lr_primal * torch.clamp_min(dev_mean(sigma), 0.01))[..., None]
        dP, mP, vP = _adam(gP, mP, vP, t, lr_P)
        dX, mX, vX = _adam(gX, mX, vX, t, cfg.lr_primal)
        dS, mS, vS = _adam(gS, mS, vS, t, lr_S)
        P = torch.minimum(torch.clamp_min(P + dP, 0.0), pmax) * m2
        X = torch.clamp(X + dX, 0.0, 1.0) * m2
        sigma = torch.clamp_min(sigma + dS, 1e-4)

        r = rate_nd(P, X)
        floor = torch.clamp_min(rmin_nd, 1.0)
        lr_d = lr_dual / torch.sqrt(t)
        beta = torch.clamp_min(beta + lr_d * (torch.sum(X, dim=-2) - 1.0), 0.0)
        iota = torch.clamp_min(iota + lr_d * ((P - _linear_cap(params, X, x_bar)) / pmax), 0.0)
        lam = torch.clamp_min(lam + lr_d * ((rmin_nd - r) / floor), 0.0)
        nu = torch.clamp_min(
            nu + lr_d * ((quad(P, sigma) * payload_nd - r) / floor), cfg.nu_min
        )
    return P, X, sigma


def solve_p5(
    params: SystemParams,
    weights: Weights,
    rho,
    T,
    f,
    P0: torch.Tensor,
    X0: torch.Tensor,
    cfg: P5Config = P5Config(),
) -> P5Solution:
    """Alg. A1: SCA outer loop with quadratic-transform y-updates."""
    payload_nd = (params.D + _col(rho) * params.C) / params.bbar      # [s]
    rmin_nd = r_min(params, rho, T, f) / params.bbar

    def ratio_sigma(P, X):
        r_nd = device_rate(params, P, X) / params.bbar
        return torch.clamp(
            torch.sum(P, dim=-1) * payload_nd / torch.clamp_min(r_nd, 1e-3), 1e-5, 1e6
        )

    P, X = P0, X0
    sigma = ratio_sigma(P, X)                                   # Alg. A1 line 3
    hs = []
    for _ in range(cfg.outer_iters):
        p_sum = torch.clamp_min(torch.sum(P, dim=-1), 1e-7)
        y = torch.clamp(1.0 / (2.0 * p_sum * sigma), 1e-4, 1e8)   # line 6 / eq. (37)
        x_bar = X                                               # SCA point
        P, X, _ = _inner_primal_dual(
            params, weights, payload_nd, rmin_nd, y, x_bar, (P, X, sigma), cfg
        )
        sigma = ratio_sigma(P, X)                               # tight epigraph
        hs.append(weights.kappa1 * torch.sum(sigma, dim=-1) - cfg.varsigma * penalty_J(X, x_bar))
    h = torch.stack(hs, dim=-1) if hs else sigma.new_zeros(sigma.shape[:-1] + (0,))
    return P5Solution(P=P, X=X, sigma=sigma, h=h)
