"""Plain optimizers on trees of tensors: SGD, AdamW, schedules.

Counterpart of `repro.optim.optimizers`, with its (init, update) convention:
``state = init(params)`` and ``params, state = update(grads, state,
params)``. A tree is a tensor or a nested dict / list / tuple of tensors;
updates return new tensors and never write into their inputs.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..core.types import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor
    mu: object | None = None
    nu: object | None = None


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor `clip_by_global_norm` scales every leaf by."""
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda x: x * scale, tree), norm


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)``, grads a tree like
    ``params``: `jax.value_and_grad` on a tree of tensors. The loss is
    taken of detached aliases of the leaves (same storage, made to require
    grad), under grad mode whatever the caller's. A leaf the loss does not
    read (HuBERT's token embedding) gets a zero gradient, as in JAX."""
    with torch.enable_grad():
        live = tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss = loss_fn(live, *args)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return lr


def sgd(lr: float | Callable, momentum: float = 0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = tree_map(torch.zeros_like, params) if momentum else None
        return OptState(step=torch.zeros((), dtype=torch.int32), mu=mu)

    def update(grads, state, params):
        step = state.step + 1
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
            delta = mu
        else:
            mu, delta = None, grads
        lr_t = lr_fn(step)
        new = tree_map(lambda p, d: p - lr_t * d.to(p.dtype), params, delta)
        return new, OptState(step=step, mu=mu)

    return init, update


def adamw(
    lr: float | Callable,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda: tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)
        return OptState(step=torch.zeros((), dtype=torch.int32), mu=zeros(), nu=zeros())

    def update(grads, state, params):
        step = state.step + 1
        t = step.to(torch.float32)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()), state.nu, grads)
        lr_t = lr_fn(step)

        def upd(p, m, v):
            mh = m / (1 - b1**t)
            vh = v / (1 - b2**t)
            d = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * d).to(p.dtype)

        new = tree_map(upd, params, mu, nu)
        return new, OptState(step=step, mu=mu, nu=nu)

    return init, update
