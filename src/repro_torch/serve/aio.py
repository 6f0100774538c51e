"""asyncio-native facade over the threaded `RealClockDriver`.

Counterpart of `repro.serve.aio`.

The driver's public surface is thread-blocking: `submit` can park on the
bounded admission queue (backpressure) and returns a
`concurrent.futures.Future`; `close` joins the solver thread. Embedding it
in an async server therefore needs both moves off the event loop:

* ``await facade.submit(params)`` runs the driver's blocking `submit` in the
  loop's default executor (so a full admission queue suspends the coroutine,
  not the loop) and then awaits the returned future via
  `asyncio.wrap_future` — the solver thread resolving it wakes the loop.
* ``async with AsyncAllocDriver(service) as facade:`` starts the underlying
  driver on entry and runs its draining `close` in the executor on exit.

The facade adds no policy of its own: every queue, batch and equivalence
property is the wrapped driver's. Sync code can reach the wrapped driver at
``facade.driver``.
"""
from __future__ import annotations

import asyncio

from ..core import SystemParams, Weights

from .driver import DriverConfig, RealClockDriver
from .ladder import LadderLearner
from .service import AllocService, Completion


class AsyncAllocDriver:
    """`RealClockDriver` with an asyncio face (see module docstring).

    Construct from a sans-IO `AllocService` (a driver is created, not yet
    started — enter the context or call `start`) or wrap an existing
    `RealClockDriver` (sharing it with sync callers; the context manager
    still closes it on exit, so only the owner should exit the context).
    """

    def __init__(
        self,
        target: AllocService | RealClockDriver,
        cfg: DriverConfig = DriverConfig(),
        ladder: LadderLearner | None = None,
    ):
        if isinstance(target, RealClockDriver):
            self.driver = target
        else:
            self.driver = RealClockDriver(target, cfg, ladder, start=False)

    @property
    def service(self) -> AllocService:
        return self.driver.service

    def start(self) -> "AsyncAllocDriver":
        self.driver.start()
        return self

    async def submit(
        self,
        params: SystemParams,
        weights: Weights | None = None,
        warm_start=None,
        accuracy=None,
        tenant=None,
    ) -> Completion:
        """Admit one scenario and await its `Completion`.

        Backpressure-safe: the blocking enqueue runs in the executor, and
        the solve itself is awaited through the driver's future — the event
        loop stays free for other coroutines while the solver thread works.
        ``warm_start``/``accuracy``/``tenant`` pass through to
        `RealClockDriver.submit` (explicit warm-start entries overriding any
        cache lookup; the per-tenant A(rho) fit stamped at prepare).
        """
        loop = asyncio.get_running_loop()
        fut = await loop.run_in_executor(
            None, self.driver.submit, params, weights, warm_start, accuracy, tenant
        )
        return await asyncio.wrap_future(fut)

    async def close(self, timeout: float | None = None) -> None:
        """Graceful drain (`RealClockDriver.close`) off the event loop."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self.driver.close, timeout)

    async def __aenter__(self) -> "AsyncAllocDriver":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()
