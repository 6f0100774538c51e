"""Projected-gradient (Adam) solver for subproblem P4(P, X).

Counterpart of `repro.core.pgd`. The parametrisation enforces the hard
constraints exactly:
  * per subcarrier k, (x_{1..N,k}, x_unassigned) = softmax over N+1 logits,
    so constraint (13d) sum_n x_{n,k} <= 1 holds by construction;
  * per device a learnable budget B_n = Pmax_n * sigmoid(w_tot_n) and a
    per-subcarrier shape P_raw = Pmax * x^q * sigmoid(w); the final
    P = P_raw * min(1, B_n / sum_k P_raw) keeps (13a)+(13b) with a budget
    that stays differentiable;
the rate floor r_n >= rmin_n is a squared hinge, and a concave x(1-x)
penalty (the paper's (32b)) pushes X to binary.

Rows of a batch are independent, so the gradient of the batch-summed loss
is each row's own gradient. The step counter is a float32 tensor, as in the
reference's scan, so the Adam bias corrections and the temperature anneal
are float32 math.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import spans
from .system import device_rate
from .types import SystemParams

_EPS = 1e-12


class PGDConfig(NamedTuple):
    steps: int = 800
    lr: float = 0.08
    penalty_rate: float = 10.0
    penalty_binary: float = 0.3
    temp_end: float = 0.25  # final softmax temperature (anneals from 1.0)


def _maximum(x, c: float):
    """max(x, c) whose gradient splits ties 0.5/0.5, as JAX's does."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def _minimum(x, c: float):
    """min(x, c) whose gradient splits ties 0.5/0.5, as JAX's does."""
    return torch.minimum(x, torch.full((), c, dtype=x.dtype, device=x.device))


def _grad(loss_fn, *xs):
    """Gradients of the batch-summed ``loss_fn(*xs)`` w.r.t. every x."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in xs]
        return torch.autograd.grad(torch.sum(loss_fn(*leaves)), leaves)


def _adam_update(g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mhat = m / (1 - b1**t)
    vhat = v / (1 - b2**t)
    return -lr * mhat / (torch.sqrt(vhat) + eps), m, v


def _logit(p):
    p = torch.clamp(p, 1e-5, 1.0 - 1e-5)
    return torch.log(p) - torch.log1p(-p)


def _budgeted_power(params: SystemParams, P_raw, w_tot):
    """P = P_raw * min(1, B_n / sum P_raw) with learnable budget B_n."""
    budget = params.p_max * torch.sigmoid(w_tot)              # (..., N)
    tot = _maximum(torch.sum(P_raw, dim=-1), _EPS)
    return P_raw * _minimum(budget / tot, 1.0)[..., None]


def _decode(params: SystemParams, z, w, w_tot, temp):
    """(z logits (..., N+1, K), w (..., N, K), w_tot (..., N)) -> feasible (P, X).

    Padded devices get a -1e9 logit (their softmax weight underflows to
    exactly 0) and padded subcarriers are zeroed, so a padded scenario decodes
    like its exact-shape twin.
    """
    row_mask = torch.cat(
        [params.dev_mask, torch.ones_like(params.dev_mask[..., :1])], dim=-1
    )                                                 # keep "unassigned"
    z = torch.where(row_mask[..., None] > 0.0, z, -1e9)
    x_full = torch.softmax(z / temp, dim=-2)          # (..., N+1, K)
    X = x_full[..., :-1, :] * params.sc_mask[..., None, :]
    q = float(params.q)
    P_raw = params.p_max[..., None] * (X**q) * torch.sigmoid(w)
    return _budgeted_power(params, P_raw, w_tot), X


def solve_p4_pgd(
    params: SystemParams,
    kappa1,
    payload: torch.Tensor,    # D_n + rho C_n  [bits]
    rmin: torch.Tensor,       # (..., N)
    P0: torch.Tensor,
    X0: torch.Tensor,
    cfg: PGDConfig = PGDConfig(),
):
    """Minimise kappa1 sum_n (sum_k p)(payload)/r_n  s.t. P1's comms constraints."""
    with spans.span("pgd", rows=_rows(P0), steps=cfg.steps):
        spans.count("adam_steps", cfg.steps)

        def loss(z, w, w_tot, temp):
            P, X = _decode(params, z, w, w_tot, temp)
            r = device_rate(params, P, X)
            frac = torch.sum(P, dim=-1) * payload / _maximum(r, _EPS)
            hinge = torch.square(_maximum(rmin - r, 0.0) / _maximum(rmin, 1.0))
            binary = torch.sum(X * (1.0 - X), dim=(-2, -1))
            return (
                kappa1 * torch.sum(frac, dim=-1)
                + cfg.penalty_rate * torch.sum(hinge, dim=-1)
                + cfg.penalty_binary * binary
            )

        # warm start from (P0, X0)
        x_aug = torch.cat(
            [torch.clamp(X0, 1e-3, 1.0),
             torch.clamp_min(1.0 - torch.sum(X0, dim=-2, keepdim=True), 1e-3)],
            dim=-2,
        )
        z = torch.log(x_aug)
        w = _logit(P0 / torch.clamp_min(
            params.p_max[..., None] * torch.clamp(X0, 1e-3, 1.0) ** 2, _EPS
        ))
        w_tot = _logit(torch.sum(P0, dim=-1) / params.p_max * 1.2)

        mz, vz = torch.zeros_like(z), torch.zeros_like(z)
        mw, vw = torch.zeros_like(w), torch.zeros_like(w)
        mt, vt = torch.zeros_like(w_tot), torch.zeros_like(w_tot)
        steps = torch.arange(cfg.steps, dtype=torch.float32, device=z.device)
        for i in steps:
            t = i + 1
            frac_done = i / max(cfg.steps - 1, 1)
            temp = 1.0 + (cfg.temp_end - 1.0) * frac_done
            gz, gw, gt = _grad(lambda z_, w_, t_: loss(z_, w_, t_, temp), z, w, w_tot)
            dz, mz, vz = _adam_update(gz, mz, vz, t, cfg.lr)
            dw, mw, vw = _adam_update(gw, mw, vw, t, cfg.lr)
            dt, mt, vt = _adam_update(gt, mt, vt, t, cfg.lr)
            z, w, w_tot = z + dz, w + dw, w_tot + dt
        return _decode(params, z, w, w_tot, cfg.temp_end)


def _rows(P: torch.Tensor) -> int:
    """Rows of a (..., N, K) leaf."""
    return P.numel() // max(P.shape[-1] * P.shape[-2], 1)


def power_given_x(
    params: SystemParams,
    kappa1,
    payload: torch.Tensor,
    rmin: torch.Tensor,
    X: torch.Tensor,          # binary (..., N, K)
    P0: torch.Tensor | None = None,
    steps: int = 600,
    lr: float = 0.08,
    penalty_rate: float = 10.0,
):
    """Re-optimise powers after hardening X to binary (per-device separable)."""
    with spans.span("power_given_x", rows=_rows(X), steps=steps):
        spans.count("adam_steps", steps)

        def decode(w, w_tot):
            P_raw = params.p_max[..., None] * X * torch.sigmoid(w)
            return _budgeted_power(params, P_raw, w_tot)

        def loss(w, w_tot):
            P = decode(w, w_tot)
            r = device_rate(params, P, X)
            frac = torch.sum(P, dim=-1) * payload / _maximum(r, _EPS)
            hinge = torch.square(_maximum(rmin - r, 0.0) / _maximum(rmin, 1.0))
            return kappa1 * torch.sum(frac, dim=-1) + penalty_rate * torch.sum(hinge, dim=-1)

        if P0 is None:
            P0 = params.p_max[..., None] * X * 0.25
        w = _logit(P0 / torch.clamp_min(params.p_max[..., None] * X, _EPS))
        w_tot = _logit(torch.sum(P0, dim=-1) / params.p_max * 1.2)
        m, v = torch.zeros_like(w), torch.zeros_like(w)
        mt, vt = torch.zeros_like(w_tot), torch.zeros_like(w_tot)
        for i in torch.arange(steps, dtype=torch.float32, device=w.device):
            g, gt = _grad(loss, w, w_tot)
            dw, m, v = _adam_update(g, m, v, i + 1, lr)
            dt, mt, vt = _adam_update(gt, mt, vt, i + 1, lr)
            w, w_tot = w + dw, w_tot + dt
        return decode(w, w_tot)
