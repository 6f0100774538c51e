"""Public entry points of the FedSem objective grid, with dispatch.

Counterpart of `repro.kernels.fedsem_objective.ops`. ``use_kernel="auto"``
(the reference's ``use_pallas="auto"``) means: the CUDA kernel iff the
tensors lie on a CUDA device, the plain version (`ref.py`) for CPU tensors.
``use_kernel=True`` on CPU tensors raises; ``use_kernel=False`` asks for
the plain version on any device. A kernel that fails raises; nothing falls
back.

* `objective_grid` — one scenario, python-float weights, feasibility on.
* `objective_grid_batch` — a leading scenario axis B with runtime weights
  and accuracy coefficients: the entry `core.scoring` uses.
"""
from __future__ import annotations

from repro_torch.device import wants_kernel

from . import kernel, ref


def objective_grid(
    f, p, r, rho,
    c, d, D, C, t_sc_max, f_max,
    xi: float, eta: float,
    kappa1: float, kappa2: float, kappa3: float,
    accuracy_ab=(0.6356, 0.4025),
    *,
    dev_mask=None,
    use_kernel: str | bool = "auto",
):
    """Objective (eq. 13) for G candidates of one scenario. f/p/r: (G, N);
    rho: (G,). ``dev_mask`` (N,) marks real devices (None = all real)."""
    if not wants_kernel(use_kernel, f):
        return ref.objective_grid(
            f, p, r, rho, c, d, D, C, t_sc_max, f_max,
            xi, eta, kappa1, kappa2, kappa3, accuracy_ab, dev_mask,
        )
    a_acc, b_acc = accuracy_ab
    return kernel.objective_grid(
        f, p, r, rho, c, d, D, C, t_sc_max, f_max, dev_mask,
        xi=float(xi), eta=float(eta),
        k1=float(kappa1), k2=float(kappa2), k3=float(kappa3),
        a_acc=float(a_acc), b_acc=float(b_acc),
    )


def objective_grid_batch(
    f, p, r, rho,
    c, d, D, C, t_sc_max, f_max,
    kappa1, kappa2, kappa3,
    *,
    xi: float, eta: float,
    accuracy_ab=(0.6356, 0.4025),
    dev_mask=None,
    check_feasible: bool = True,
    use_kernel: str | bool = "auto",
):
    """Objective (eq. 13) for B scenarios x G candidates -> (B, G).

    f/p/r (B, G, N); rho (B, G); parameter rows and ``dev_mask`` (B, N);
    ``kappa1..3`` and ``accuracy_ab`` are python floats, scalars or (B,)
    tensors. ``check_feasible=False`` returns the raw eq. 13 score (the
    `system.objective` semantics the allocator's selection uses).
    """
    if not wants_kernel(use_kernel, f):
        return ref.objective_grid_batch(
            f, p, r, rho, c, d, D, C, t_sc_max, f_max,
            kappa1, kappa2, kappa3,
            xi=xi, eta=eta, accuracy_ab=accuracy_ab, dev_mask=dev_mask,
            check_feasible=check_feasible,
        )
    a_acc, b_acc = accuracy_ab
    return kernel.objective_batch(
        f, p, r, rho, c, d, D, C, t_sc_max, f_max, dev_mask,
        kappa1, kappa2, kappa3, a_acc, b_acc,
        xi=float(xi), eta=float(eta), check_feasible=check_feasible,
    )
