"""Pluggable allocation backends: where `run_fl` gets each round's resources.

Counterpart of `repro.fl.alloc_backend`. `PlannedBackend` is the offline
path: one batched `solve_batch` over every round's pre-sampled scenario
before training starts. `ServiceBackend` submits each round's
`SystemParams` to the live serving stack (`AllocService` on a virtual
clock, or a `RealClockDriver` / its asyncio facade) and blocks on the
answer, which is how concurrent FL jobs share one allocation service and
how a job's re-fit A(rho) steers its own later rounds
(`repro_torch.fl.semcom_job`).

Equivalence (tests/test_torch_fl.py, `fedsem_e2e`): for the same round
scenarios and the same `AllocatorConfig`, `ServiceBackend` returns the
hardened assignment X that `PlannedBackend` computes: padding into shape
buckets and co-batching change scheduling, never answers.
"""
from __future__ import annotations

from typing import Sequence

from ..core import (
    Allocation,
    AllocatorConfig,
    AllocatorResult,
    SystemParams,
    Weights,
    solve_batch,
    stack_params,
    tree_index,
)
from ..serve.driver import RealClockDriver
from ..serve.service import AllocService, ServeConfig
from ..serve.warmstart import entry_from_alloc


class AllocationBackend:
    """Protocol for `run_fl`'s per-round allocation source.

    Lifecycle: `open(scenarios, weights)` once with every round's
    `SystemParams` (the FL driver samples them, so all backends price the
    same channels), `allocate(rnd)` per round (blocking until the round's
    `Allocation` is ready), `close()` when the run ends. `close` releases
    only what the backend itself created: a borrowed service or driver stays
    up, so one driver can serve many jobs. `set_accuracy` offers a re-fit
    A(rho) for later rounds and returns whether it took effect;
    `supports_accuracy_feedback` says so up front.
    """

    supports_accuracy_feedback: bool = False

    def open(self, scenarios: Sequence[SystemParams], weights: Weights) -> None:
        raise NotImplementedError

    def allocate(self, rnd: int) -> Allocation:
        raise NotImplementedError

    def set_accuracy(self, acc) -> bool:
        return False

    def close(self) -> None:
        pass


class PlannedBackend(AllocationBackend):
    """The offline path: one batched solve of every round before training
    starts, on the scenarios' device. It declines refits: every round is
    solved already. ``sys_batch`` / ``result`` expose the whole plan."""

    supports_accuracy_feedback = False

    def __init__(
        self,
        allocator: AllocatorConfig = AllocatorConfig(inner="pgd"),
        accuracy=None,
    ):
        self.allocator = allocator
        self.accuracy = accuracy
        self.sys_batch: SystemParams | None = None
        self.result: AllocatorResult | None = None

    def open(self, scenarios: Sequence[SystemParams], weights: Weights) -> None:
        self.sys_batch = stack_params(list(scenarios))
        self.result = solve_batch(self.sys_batch, weights, self.allocator, self.accuracy)

    def allocate(self, rnd: int) -> Allocation:
        return tree_index(self.result.alloc, rnd)


class ServiceBackend(AllocationBackend):
    """Round allocations served by the live allocation stack.

    ``target`` is an `AllocService` (virtual clock: round ``rnd`` is admitted
    at time ``rnd`` and drained at once; single-tenant, since `drain` flushes
    every queue), a `RealClockDriver` (``submit`` returns a future that
    `allocate` waits on; many jobs in threads share one driver and their
    rounds co-batch), or a `repro_torch.serve.aio.AsyncAllocDriver`, which
    is unwrapped to its driver. The target is borrowed, never owned.

    ``warm_rounds=True`` sends the previous round's hardened (f, P, X) with
    each request as an explicit warm start (a `serve.warmstart.CacheEntry`):
    the round's objective can only improve or tie against a cold solve.

    ``tenant`` scopes accuracy feedback to this backend's own rounds: every
    submit carries the tenant id and `set_accuracy` updates only that
    tenant's fit, so jobs sharing one driver never see each other's refits.
    None keeps the all-tenants default.
    """

    supports_accuracy_feedback = True

    def __init__(self, target, *, timeout_s: float = 600.0, warm_rounds: bool = False, tenant=None):
        target = getattr(target, "driver", target)  # unwrap the asyncio facade
        if isinstance(target, RealClockDriver):
            self._driver: RealClockDriver | None = target
            self._service = target.service
        elif isinstance(target, AllocService):
            self._driver = None
            self._service = target
        else:
            raise TypeError(
                "ServiceBackend target must be an AllocService, a "
                f"RealClockDriver or an AsyncAllocDriver, got {type(target)!r}"
            )
        self._timeout_s = timeout_s
        self._warm_rounds = warm_rounds
        self.tenant = tenant
        self._prev_alloc: Allocation | None = None
        self._scenarios: list[SystemParams] = []
        self._weights: Weights | None = None

    def open(self, scenarios: Sequence[SystemParams], weights: Weights) -> None:
        self._scenarios = list(scenarios)
        self._weights = weights
        self._prev_alloc = None

    def _warm_entry(self, params: SystemParams):
        """The previous round's solution as a warm-start entry, while shapes
        still match (a population change resets the chain)."""
        if not self._warm_rounds or self._prev_alloc is None:
            return None
        prev = self._prev_alloc
        if tuple(prev.X.shape) != (params.N, params.K):
            return None
        return entry_from_alloc(prev)

    def allocate(self, rnd: int) -> Allocation:
        params = self._scenarios[rnd]
        warm = self._warm_entry(params)
        if self._driver is not None:
            fut = self._driver.submit(params, self._weights, warm_start=warm, tenant=self.tenant)
            alloc = fut.result(timeout=self._timeout_s).alloc
        else:
            req_id = self._service.submit(
                params, self._weights, now=float(rnd), warm_start=warm, tenant=self.tenant,
            )
            done, _ = self._service.drain(now=float(rnd))
            alloc = next(c.alloc for c in done if c.req_id == req_id)
        if self._warm_rounds:
            self._prev_alloc = alloc
        return alloc

    def set_accuracy(self, acc) -> bool:
        self._service.set_accuracy(acc, tenant=self.tenant)
        return True


def serve_config_for(allocator: AllocatorConfig, **overrides) -> ServeConfig:
    """A `ServeConfig` whose solver matches an FL run's `AllocatorConfig`:
    the precondition of ServiceBackend == PlannedBackend (the solver cache
    keys on the config)."""
    return ServeConfig(allocator=allocator, **overrides)
