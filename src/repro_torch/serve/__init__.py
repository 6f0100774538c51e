"""Allocation serving layer: micro-batched scenario service over `solve_batch`.

Counterpart of `repro.serve`, with the same public names. The pipeline is
request -> `pad_params` into a `ShapeBucket` -> per-bucket admission queue
(`MicroBatcher`) -> one bound `solve_batch` solver per (bucket, batch slots,
AllocatorConfig) -> hardened exact-shape `Allocation` back to the caller,
scored by the objective kernel (`Completion.objective`), with latency,
queue-depth and batch-occupancy metrics along the way.

Two drivers sit on the sans-IO core: the virtual-clock load generator
(`loadgen.run_load`) and the real-clock threaded `driver.RealClockDriver`
(bounded admission queue, solver thread, deadline timer, graceful drain),
with an asyncio face (`aio.AsyncAllocDriver`). `ladder.LadderLearner` learns
a bucket ladder from the observed shape mix; `warmstart.WarmStartCache`
feeds recorded solutions back as extra multi-start candidates (never worse
by dominance, bit for bit cold when missing).

Padding, co-batching, the kernel objective path and the real-clock driver
are transparent: each request's hardened allocation matches a solo
exact-shape solve, asserted in `tests/test_torch_serving.py`,
`tests/test_torch_warmstart.py` and `tests/test_torch_serve_driver.py`.
Scenario sharding (``ServeConfig.shard_batch``) is not ported yet
(ROADMAP.md §1, item 9).
"""
from .aio import AsyncAllocDriver
from .batching import BatchPolicy, MicroBatcher, PendingRequest
from .driver import (
    AdmissionQueueFull, DriverClosed, DriverConfig, RealClockDriver,
    pace_stream, same_hardened_assignments,
)
from .ladder import (
    LadderLearner, LadderSnapshot, learn_buckets, padded_area_waste,
)
from .loadgen import LoadResult, poisson_arrivals, run_load, scenario_stream
from .metrics import Reservoir, ServiceMetrics, percentile
from .service import AllocService, Completion, ServeConfig
from .warmstart import (
    CacheEntry, WarmStartCache, WarmStartConfig, batch_starts,
    entry_from_alloc, iters_to_converge, pad_start, request_signature,
)

__all__ = [
    "AllocService", "Completion", "ServeConfig",
    "WarmStartCache", "WarmStartConfig", "CacheEntry", "request_signature",
    "entry_from_alloc", "pad_start", "batch_starts", "iters_to_converge",
    "BatchPolicy", "MicroBatcher", "PendingRequest",
    "ServiceMetrics", "Reservoir", "percentile",
    "LoadResult", "poisson_arrivals", "run_load", "scenario_stream",
    "AsyncAllocDriver",
    "RealClockDriver", "DriverConfig", "AdmissionQueueFull", "DriverClosed",
    "pace_stream", "same_hardened_assignments",
    "LadderLearner", "LadderSnapshot", "learn_buckets", "padded_area_waste",
]
