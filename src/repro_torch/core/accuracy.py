"""Accuracy-vs-compression-rate models A(rho) (paper Assumption 1, Fig. 8b).

Counterpart of `repro.core.accuracy`: the paper's YOLOv5/COCO fit
``A(rho) = 0.6356 * rho**0.4025`` as a power law with runtime coefficients.
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
