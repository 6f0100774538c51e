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
* `bound_objective_grid_batch` — the same, bound to its argument tensors
  once, for a caller that rewrites an input in place and scores again (the
  exhaustive sweep's rate tile): the kernel's arguments are checked once.
"""
from __future__ import annotations

import torch

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


def bound_objective_grid_batch(
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
    """`objective_grid_batch` on these tensors as a zero-argument callable.

    Each call scores the tensors' current contents: the caller may rewrite
    them in place between calls, never replace them. The kernel route
    checks and lays out its arguments here, once (`kernel.prepare`), and
    each call is one launch; its (B, G) output buffer is reused by the next
    call. The inputs must already be what the kernel takes (contiguous
    float32 of the stated shapes), so that no argument is copied.
    """
    kw = dict(xi=xi, eta=eta, dev_mask=dev_mask, check_feasible=check_feasible)
    args = (f, p, r, rho, c, d, D, C, t_sc_max, f_max, kappa1, kappa2, kappa3)
    if not wants_kernel(use_kernel, f):
        return lambda: ref.objective_grid_batch(*args, accuracy_ab=accuracy_ab, **kw)
    a_acc, b_acc = accuracy_ab
    prep = kernel.prepare(
        f, p, r, rho, c, d, D, C, t_sc_max, f_max, dev_mask,
        kappa1, kappa2, kappa3, a_acc, b_acc,
        xi=float(xi), eta=float(eta), check_feasible=check_feasible,
    )
    for given, laid_out in zip((f, p, r, rho), prep.ins):
        if laid_out.data_ptr() != torch.as_tensor(given).data_ptr():
            raise ValueError(
                "bound_objective_grid_batch: f, p, r and rho must be contiguous "
                "float32 tensors on one card (a copy would not see rewrites)"
            )
    return lambda: kernel.launch(prep)
