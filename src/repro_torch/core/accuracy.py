"""Accuracy-vs-compression-rate models A(rho) (paper Assumption 1, Fig. 8b).

Counterpart of `repro.core.accuracy`: the paper's YOLOv5/COCO fit
``A(rho) = 0.6356 * rho**0.4025`` as a power law with runtime coefficients,
and `fit_power_law`, the least-squares refit a `fl.SemComJob` makes from its
own measurements.
"""
from __future__ import annotations

import dataclasses

import torch

from .types import tree_map


@dataclasses.dataclass(frozen=True)
class AccuracyFn:
    """A(rho) = a * rho**b with a > 0, 0 < b < 1 (increasing + concave).

    ``a``/``b`` are scalars or (B,) tensors (one fit per stacked scenario).
    """

    a: torch.Tensor
    b: torch.Tensor

    def value(self, rho):
        rho = torch.clamp_min(torch.as_tensor(rho, dtype=torch.float32), 1e-9)
        return self.a * torch.pow(rho, self.b)

    def deriv(self, rho):
        rho = torch.clamp_min(torch.as_tensor(rho, dtype=torch.float32), 1e-9)
        return self.a * self.b * torch.pow(rho, self.b - 1.0)


def default_accuracy(device=None) -> AccuracyFn:
    """The paper's YOLOv5/COCO fit: A(rho) = 0.6356 rho^0.4025."""
    return AccuracyFn(
        torch.tensor(0.6356, dtype=torch.float32, device=device),
        torch.tensor(0.4025, dtype=torch.float32, device=device),
    )


def stack_accuracy(acc_list) -> AccuracyFn:
    """Stack per-scenario fits over a new leading batch axis (feeds
    ``solve_batch(..., acc_batched=True)``)."""
    acc_list = list(acc_list)
    if not acc_list:
        raise ValueError("stack_accuracy needs at least one AccuracyFn")
    return tree_map(lambda *xs: torch.stack(xs), *acc_list)


def fit_power_law(rhos, accs) -> AccuracyFn:
    """Least-squares fit of log A = log a + b log rho (as the paper's MATLAB
    fit), in float32 with the reference's 1e-9 floors; b is clipped to
    [0.05, 0.95] to keep Assumption 1 (increasing, concave)."""
    rhos = torch.as_tensor(rhos, dtype=torch.float32)
    accs = torch.as_tensor(accs, dtype=torch.float32)
    x = torch.log(torch.clamp_min(rhos, 1e-9))
    y = torch.log(torch.clamp_min(accs, 1e-9))
    xm, ym = torch.mean(x), torch.mean(y)
    b = torch.sum((x - xm) * (y - ym)) / torch.clamp_min(torch.sum(torch.square(x - xm)), 1e-12)
    log_a = ym - b * xm
    b = torch.clamp(b, 0.05, 0.95)
    return AccuracyFn(torch.exp(log_a), b)
