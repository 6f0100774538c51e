"""Federated-learning substrate (paper Stage 1) wired to the resource allocator.

Counterpart of `repro.fl.federated`. Every round's wireless scenario is
sampled up front (block fading, i.i.d. across rounds, paper §III) with the
per-client upload size D_n taken from the model being trained; where each
round's allocation comes from is pluggable (`fl.alloc_backend`: one batched
solve of every round, or the live serving stack). Then, per round:

  1. every client runs ``local_steps`` of SGD on its own batches, uploads a
     top-|rho| sparsified update, and the server averages them (FedAvg);
  2. the round's energy and delay follow from its allocation through the
     system model and go into the history.

Randomness: the reference splits and folds a JAX key; the port derives an
integer seed per purpose with `fold_seed` (numpy's ``SeedSequence``) and
draws from a fresh `torch.Generator` per (round, client, step), never from
the global RNG. So concurrent jobs share no generator, and a job's run
depends on its seed only. ``client_batch_fn(gen, client)`` and
``loss_fn(params, batch, gen[, rho])`` receive those generators; a caller
that brings its own draws (the parity tests) may ignore them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core import AllocatorConfig, AllocatorResult, SystemParams, Weights, tree_bits
from ..core.system import report
from ..core.types import tree_leaves, tree_map
from ..optim.optimizers import sgd, value_and_grad
from ..scenarios import generator, get_family
from .alloc_backend import AllocationBackend, PlannedBackend


class FLConfig(NamedTuple):
    n_clients: int = 10
    n_subcarriers: int = 50
    rounds: int = 20
    local_steps: int = 5
    lr: float = 0.05
    kappa: tuple = (1.0, 1.0, 1.0)
    allocator_inner: str = "pgd"   # fast + strong inner for the driver
    compress: bool = True          # top-|rho| update sparsification
    scenario: str = "iid_rayleigh"  # registered scenario family for channels
    seed: int = 0
    #: call the loss as ``loss_fn(params, batch, gen, rho)`` with the round's
    #: solved rho (rho-aware models, e.g. the SemCom codec)
    rho_in_loss: bool = False


class RoundStats(NamedTuple):
    loss: float
    rho: float
    energy: float
    t_fl: float
    objective: float
    upload_bits: float


def fold_seed(seed: int, *path: int) -> int:
    """A seed derived from ``seed`` and a path of non-negative integers
    (numpy's ``SeedSequence`` spawn key): the port's `jax.random.fold_in`."""
    state = np.random.SeedSequence(entropy=int(seed), spawn_key=tuple(int(p) for p in path))
    return int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def round_channel_seed(seed: int, rnd: int) -> int:
    """The channel seed of round ``rnd``: shared by the batched planner and
    any sequential reference, so both sample the same scenarios."""
    return fold_seed(seed, rnd, 0)


def sample_round_scenarios(seed: int, cfg: FLConfig, d_bits: float, device="cuda") -> list[SystemParams]:
    """Every round's wireless scenario from the ``cfg.scenario`` family, one
    generator per round. Sampling lives in the FL driver, not in the
    backends, so every backend prices the same channels for a seed."""
    family = get_family(cfg.scenario)
    return [
        family.sample(
            round_channel_seed(seed, rnd), device=device,
            N=cfg.n_clients, K=cfg.n_subcarriers, D_bits=d_bits,
        )
        for rnd in range(cfg.rounds)
    ]


def plan_allocations(
    seed: int, cfg: FLConfig, d_bits: float, weights: Weights, device="cuda"
) -> tuple[SystemParams, AllocatorResult]:
    """Sample every round's scenario and solve all allocations at once:
    `PlannedBackend`'s plan, returned whole (the stacked ``SystemParams``,
    leading axis = round, and the batched `AllocatorResult`)."""
    backend = PlannedBackend(AllocatorConfig(inner=cfg.allocator_inner))
    backend.open(sample_round_scenarios(seed, cfg, d_bits, device), weights)
    return backend.sys_batch, backend.result


def magnitude_quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of the flat tensor ``a``, linearly interpolated in
    `jnp.quantile`'s arithmetic (``method="linear"``): the rank q (n - 1) in
    float32 with n itself rounded to float32, the order statistics at its
    floor and ceil, ``lo (1 - w) + hi w`` in float32, cast to ``a``'s type.

    Both order statistics are read from one sort, which takes any length
    (`torch.quantile` raises above 2^24 elements, and a full-width LM's
    leaves are larger: Qwen2.5-3B's embedding has 311 M) and runs on the
    whole card (`torch.kthvalue` selects in a single thread block there)."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    n = a.numel()
    n_f = f32(float(n))
    pos = f32(q) * (n_f - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    ordered = torch.sort(a).values
    stat = lambda r: ordered[int(torch.clamp(r, 0.0, n_f - 1.0))].float()
    lo, hi = stat(low), stat(high)
    return (lo * w_low.to(a.device) + hi * w_high.to(a.device)).to(a.dtype)


def topk_sparsify(update, frac):
    """Keep the largest-|.| ``frac`` of entries per leaf (rho-compression):
    a per-leaf magnitude threshold at the (1 - frac) quantile
    (`magnitude_quantile`); entries at or above it stay."""
    q = min(max(1.0 - float(frac), 0.0), 1.0)

    def leaf_q(u):
        mag = torch.abs(u)
        return torch.where(mag >= magnitude_quantile(mag.reshape(-1), q), u, 0.0)

    return tree_map(leaf_q, update)


def run_fl(
    seed: int,
    init_params,
    loss_fn: Callable,            # loss_fn(params, batch, gen[, rho]) -> scalar
    client_batch_fn: Callable,    # client_batch_fn(gen, client_idx) -> batch
    cfg: FLConfig = FLConfig(),
    backend: AllocationBackend | None = None,
    round_hook: Callable | None = None,
):
    """Run FL with per-round wireless resource allocation; returns (params,
    history).

    The scenarios, training and FedAvg live on ``init_params``' device.
    ``backend`` chooses the allocation source (default: a fresh
    `PlannedBackend`). ``round_hook(rnd, params, alloc, stats)`` runs after
    each round's aggregation: a `SemComJob` measures its proxy accuracy
    there and pushes an A(rho) refit into a live backend.
    """
    params = tree_map(lambda x: x.detach(), init_params)
    device = tree_leaves(params)[0].device
    opt_init, opt_update = sgd(cfg.lr)
    w = Weights(*(torch.tensor(k, dtype=torch.float32, device=device) for k in cfg.kappa))
    d_bits = tree_bits(params)

    def local_train(params, batches, step_gens, rho):
        """One client's ``local_steps`` SGD steps: (delta, mean loss)."""
        p, state = params, opt_init(params)
        losses = []
        for batch, gen in zip(batches, step_gens):
            extra = (rho,) if cfg.rho_in_loss else ()
            loss, g = value_and_grad(loss_fn, p, batch, gen, *extra)
            with torch.no_grad():
                p, state = opt_update(g, state, p)
            losses.append(loss)
        delta = tree_map(lambda a, b: a - b, p, params)
        return delta, torch.mean(torch.stack(losses))

    # the paper's core: sample every round's scenario, then let the backend
    # answer them, in one batched solve or round by round through a service
    scenarios = sample_round_scenarios(seed, cfg, d_bits, device)
    if backend is None:
        backend = PlannedBackend(AllocatorConfig(inner=cfg.allocator_inner))
    backend.open(scenarios, w)

    history: list[RoundStats] = []
    try:
        for rnd in range(cfg.rounds):
            alloc = backend.allocate(rnd)
            rho = float(alloc.rho)
            stats = report(scenarios[rnd], w, alloc)
            rho_f32 = torch.tensor(rho, dtype=torch.float32)

            deltas, losses = [], []
            for i in range(cfg.n_clients):
                steps = range(cfg.local_steps)
                batches = [client_batch_fn(generator(fold_seed(seed, rnd, 1, i, s), device), i)
                           for s in steps]
                gens = [generator(fold_seed(seed, rnd, 2, i, s), device) for s in steps]
                delta, loss = local_train(params, batches, gens, rho_f32)
                deltas.append(topk_sparsify(delta, rho) if cfg.compress else delta)
                losses.append(loss)

            # FedAvg over the rho-compressed uploads
            agg = tree_map(lambda *ds: torch.mean(torch.stack(ds), dim=0), *deltas)
            params = tree_map(lambda p, d: p + d, params, agg)

            history.append(
                RoundStats(
                    loss=float(torch.mean(torch.stack(losses))),
                    rho=rho,
                    energy=float(stats["energy_total"]),
                    t_fl=float(stats["t_fl"]),
                    objective=float(stats["objective"]),
                    upload_bits=rho * d_bits * cfg.n_clients,
                )
            )
            if round_hook is not None:
                round_hook(rnd, params, alloc, history[-1])
    finally:
        backend.close()
    return params, history
