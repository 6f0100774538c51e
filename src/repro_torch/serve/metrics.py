"""Serving metrics: latency percentiles, queue depth, batch occupancy, cache.

Counterpart of `repro.serve.metrics` (plain Python; the port keeps its own
copy, and a `Reservoir` samples with the same seeded `random.Random`, so
its samples equal the reference's).

Plain-python accumulators (the service's control plane is host-side; only the
solves run on device), so they are cheap to sample on every submit/flush and
trivially serialisable into benchmark JSON.

Every distribution metric lives in a bounded `Reservoir`: an indefinitely
running driver (`serve.driver`) must not grow per-request lists without
bound. Below the cap the reservoir holds every observation, so percentiles
are exact; above it, it keeps a uniform random sample (Vitter's Algorithm R,
deterministically seeded) and percentiles become sample estimates — while
count / mean / max stay exact running aggregates regardless of volume.
"""
from __future__ import annotations

import dataclasses
import random

import numpy as np

#: default per-metric sample cap: exact percentiles up to this many
#: observations, ~32 KiB of floats per metric forever after
RESERVOIR_CAP = 4096


def percentile(values, q: float) -> float:
    """q-th percentile (0..100, linear interpolation); nan on empty."""
    if isinstance(values, Reservoir):
        values = values.sample
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Reservoir:
    """Bounded stream accumulator: exact below ``cap``, sampled above.

    ``add`` keeps every value until ``cap`` observations, then switches to
    Algorithm-R uniform reservoir sampling, so `percentile` is exact for
    short runs (every test and smoke benchmark) and an unbiased estimate for
    unbounded ones. ``count``/``total``(-> `mean`)/`max` are exact running
    aggregates either way. The RNG is seeded per-reservoir, so summaries are
    reproducible run-to-run.
    """

    __slots__ = ("cap", "count", "total", "_max", "_sample", "_rng")

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0):
        if cap < 1:
            raise ValueError(f"Reservoir cap must be >= 1, got {cap}")
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._max = None
        self._sample: list[float] = []
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if self._max is None or x > self._max:
            self._max = x
        if len(self._sample) < self.cap:
            self._sample.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._sample[j] = x

    def __len__(self) -> int:
        """Observations seen (not the retained-sample size — see `sample`)."""
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    @property
    def sample(self) -> list[float]:
        """The retained values (everything below the cap, a uniform sample
        above it); at most ``cap`` long by construction."""
        return self._sample

    def mean(self) -> float:
        """Exact running mean; nan on empty."""
        return self.total / self.count if self.count else float("nan")

    def max(self, default: float = 0.0) -> float:
        """Exact running max; ``default`` on empty."""
        return self._max if self._max is not None else default

    def percentile(self, q: float) -> float:
        """q-th percentile of the retained sample (exact below the cap)."""
        return percentile(self._sample, q)


@dataclasses.dataclass
class ServiceMetrics:
    """Per-service counters and reservoirs (one instance per `AllocService`)."""

    latencies_s: Reservoir = dataclasses.field(default_factory=Reservoir)  # arrival -> done
    waits_s: Reservoir = dataclasses.field(default_factory=Reservoir)      # arrival -> flush
    solves_s: Reservoir = dataclasses.field(default_factory=Reservoir)     # per batch
    queue_depth: Reservoir = dataclasses.field(default_factory=Reservoir)  # sampled on submit
    occupancy: Reservoir = dataclasses.field(default_factory=Reservoir)    # real / slots
    #: outer iterations Alg. A2 needed to converge, split by whether the
    #: request rode a warm start (`warmstart.iters_to_converge`) — the
    #: solve-iteration-savings evidence
    warm_iters: Reservoir = dataclasses.field(default_factory=Reservoir)
    cold_iters: Reservoir = dataclasses.field(default_factory=Reservoir)
    submitted: int = 0
    completed: int = 0
    batches: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    compile_s: float = 0.0
    warm_hits: int = 0
    warm_misses: int = 0

    def observe_submit(self, depth: int) -> None:
        self.submitted += 1
        self.queue_depth.add(depth)

    def observe_batch(self, n_real: int, slots: int, solve_s: float) -> None:
        self.batches += 1
        self.occupancy.add(n_real / max(slots, 1))
        self.solves_s.add(solve_s)

    def observe_completion(self, latency_s: float, wait_s: float) -> None:
        self.completed += 1
        self.latencies_s.add(latency_s)
        self.waits_s.add(wait_s)

    def observe_warm(self, hit: bool, iters: int) -> None:
        """Record one completed request's convergence iterations under the
        warm/cold split (only called when the service has warm starts in
        play, so a cold-only service's summary stays unchanged)."""
        if hit:
            self.warm_hits += 1
            self.warm_iters.add(iters)
        else:
            self.warm_misses += 1
            self.cold_iters.add(iters)

    def observe_cache(self, hit: bool, compile_s: float = 0.0) -> None:
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
            self.compile_s += compile_s

    def summary(self) -> dict:
        return {
            "requests": self.submitted,
            "completed": self.completed,
            "batches": self.batches,
            "latency_p50_s": self.latencies_s.percentile(50.0),
            "latency_p95_s": self.latencies_s.percentile(95.0),
            "latency_mean_s": self.latencies_s.mean(),
            "wait_p50_s": self.waits_s.percentile(50.0),
            "solve_mean_s": self.solves_s.mean(),
            "queue_depth_max": int(self.queue_depth.max(default=0)),
            "queue_depth_mean": self.queue_depth.mean(),
            "batch_occupancy_mean": self.occupancy.mean(),
            "mean_batch_size": self.completed / max(self.batches, 1),
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "compile_s": self.compile_s,
            "warm_hits": self.warm_hits,
            "warm_misses": self.warm_misses,
            "warm_iters_mean": self.warm_iters.mean(),
            "cold_iters_mean": self.cold_iters.mean(),
        }
