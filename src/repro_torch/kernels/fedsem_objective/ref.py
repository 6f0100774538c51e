"""Plain PyTorch version of the FedSem objective grid (eq. 13).

Counterpart of `repro.kernels.fedsem_objective.ref`, formula for formula:
``a * exp(b * log(max(rho, 1e-9)))`` rather than ``rho ** b``, masking by
select rather than multiply, and the same operation order as the CUDA
kernel in ``csrc/objective.cu``, so kernel and plain version differ only in
the order of the sum over devices.

`objective_grid_batch`: f/p/r (B, G, N), rho (B, G), per-scenario parameter
rows (B, N), runtime weights and accuracy coefficients (python floats,
scalars or (B,) tensors). `objective_grid` is the one-scenario view.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def objective_grid_batch(
    f, p, r, rho,
    c, d, D, C, t_sc_max, f_max,
    kappa1, kappa2, kappa3,
    *,
    xi: float, eta: float,
    accuracy_ab=(0.6356, 0.4025),
    dev_mask=None,
    check_feasible: bool = True,
):
    """Objective (eq. 13) for B scenarios x G candidates -> (B, G).

    ``dev_mask`` rows mark real devices; padded rows are excluded from the
    device count, the energy/delay reductions and the feasibility checks.
    ``check_feasible=False`` returns the raw eq. 13 value (the
    `system.objective` semantics); otherwise a candidate that misses the
    SemCom deadline or exceeds f_max on a real device scores +inf.
    """
    dev = torch.as_tensor(f).device

    def t32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    f = t32(f)
    p = t32(p)
    r = torch.clamp_min(t32(r), _EPS)
    rho = t32(rho)[..., None]                                  # (B, G, 1)
    a_acc, b_acc = accuracy_ab
    if dev_mask is None:
        dev_mask = torch.ones(f.shape[:1] + f.shape[-1:], dtype=torch.float32, device=dev)
    mask = t32(dev_mask)[:, None, :]                           # (B, 1, N)
    real = mask > 0.0

    def col(v):  # (B,) / scalar -> (B, 1) broadcastable over candidates
        return t32(v).reshape(-1, 1)

    cd = (t32(c) * t32(d))[:, None, :]
    D2 = t32(D)[:, None, :]
    C2 = t32(C)[:, None, :]

    tau = D2 / r                                               # FL upload delay
    t_c = eta * cd / torch.clamp_min(f, _EPS)
    e_t = p * tau
    e_c = xi * eta * cd * (f * f)
    e_sc = p * rho * C2 / r
    # padded rows must not leak into any device reduction: select, don't
    # multiply (a masked multiply turns inf into nan)
    e_dev = torch.where(real, e_t + e_c + e_sc, 0.0)
    t_fl = torch.amax(torch.where(real, tau + t_c, -torch.inf), dim=-1)   # (B, G)
    acc = col(a_acc) * torch.exp(col(b_acc) * torch.log(torch.clamp_min(rho[..., 0], 1e-9)))
    n_dev = torch.sum(mask[:, 0, :], dim=-1, keepdim=True)     # (B, 1) real count

    obj = (
        col(kappa1) * torch.sum(e_dev, dim=-1)
        + col(kappa2) * t_fl
        - col(kappa3) * n_dev * acc
    )
    if not check_feasible:
        return obj
    t_sc = rho * C2 / r
    bad = torch.any((t_sc > t32(t_sc_max)[:, None, :]) & real, dim=-1) | torch.any(
        (f > t32(f_max)[:, None, :] * (1.0 + 1e-6)) & real, dim=-1
    )
    return torch.where(bad, torch.inf, obj)


def objective_grid(
    f, p, r, rho,
    c, d, D, C, t_sc_max, f_max,
    xi: float, eta: float,
    kappa1: float, kappa2: float, kappa3: float,
    accuracy_ab=(0.6356, 0.4025),
    dev_mask=None,
    check_feasible: bool = True,
):
    """Single-scenario view of `objective_grid_batch`: f/p/r (G, N), rho (G,)."""
    f = torch.as_tensor(f)
    if dev_mask is None:
        dev_mask = torch.ones((f.shape[-1],), dtype=torch.float32, device=f.device)

    def one(x):
        return torch.as_tensor(x, device=f.device)[None]

    return objective_grid_batch(
        one(f), one(p), one(r), one(rho),
        one(c), one(d), one(D), one(C), one(t_sc_max), one(f_max),
        kappa1, kappa2, kappa3,
        xi=xi, eta=eta, accuracy_ab=accuracy_ab,
        dev_mask=one(dev_mask),
        check_feasible=check_feasible,
    )[0]
