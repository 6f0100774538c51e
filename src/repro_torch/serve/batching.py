"""Admission queue + micro-batching policy for the allocation service.

Counterpart of `repro.serve.batching` (plain Python; the port keeps its own
copy).

Requests are grouped into per-bucket FIFO queues (a bucket key pins both the
padded (N, K) shape and the scenario meta, so everything in one queue can
stack into a single `solve_batch` call). A bucket is flushed when it is
*full* (``max_batch`` requests waiting) or *due* (its oldest request has
waited ``max_wait_s``). The batcher is sans-IO: it never reads a clock, the
caller passes ``now`` — which makes the policy exactly testable and lets the
load generator drive it on a virtual clock.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import NamedTuple

from ..core import SystemParams, Weights


class BatchPolicy(NamedTuple):
    """Flush when a bucket holds ``max_batch`` requests or the oldest one has
    waited ``max_wait_s`` seconds — the classic latency/occupancy trade."""

    max_batch: int = 8
    max_wait_s: float = 0.05


@dataclasses.dataclass
class PendingRequest:
    """One admitted scenario waiting in a bucket queue."""

    req_id: int
    params: SystemParams        # exact shape, as submitted
    padded: SystemParams        # padded into the bucket (masks set)
    weights: Weights
    arrival_t: float
    #: the A(rho) fit this request solves AND scores under, resolved at
    #: `prepare` (explicit arg > tenant registry > service default) — rides
    #: the batch as one row of the stacked runtime accuracy argument, so
    #: co-batched tenants with different beliefs never see each other's
    #: model. None only for hand-built requests; the service always stamps it
    accuracy: object | None = None
    #: exact-shape warm-start candidate(s) attached at `prepare` (a
    #: `warmstart.CacheEntry`, or a tuple of them for top-k
    #: lookups — cache hit or explicit caller injection); None = cold request
    warm_start: object | None = None
    #: the request's warm-cache signature (computed once at `prepare`, reused
    #: to record the hardened solution after the flush); None when the
    #: service runs without a cache
    warm_sig: tuple | None = None


class MicroBatcher:
    """Per-bucket FIFO queues with the max-batch / max-wait flush policy.

    Guarantees: requests in one bucket are answered in submission order
    (`pop` is FIFO and caps at ``max_batch``); a request only ever co-batches
    with requests whose bucket key — padded shape AND scenario meta — is
    identical, so batching cannot change any request's compiled program or
    its answer (the `AllocService` equivalence contract). Time never comes
    from a clock here: ``now`` is caller-supplied, so the real-clock driver
    and the virtual-clock load generator exercise byte-identical policy.
    """

    def __init__(self, policy: BatchPolicy):
        self.policy = policy
        self._queues: dict[tuple, deque[PendingRequest]] = {}

    def add(self, key: tuple, req: PendingRequest) -> None:
        self._queues.setdefault(key, deque()).append(req)

    def depth(self) -> int:
        """Total requests waiting across all buckets."""
        return sum(len(q) for q in self._queues.values())

    def keys(self) -> list[tuple]:
        return [k for k, q in self._queues.items() if q]

    def deadline(self, key: tuple) -> float:
        """Virtual time at which this bucket becomes due (oldest + max_wait)."""
        return self._queues[key][0].arrival_t + self.policy.max_wait_s

    def next_deadline(self) -> float | None:
        """Earliest due-time across non-empty buckets (None when idle)."""
        deadlines = [self.deadline(k) for k in self.keys()]
        return min(deadlines) if deadlines else None

    def full_keys(self) -> list[tuple]:
        return [
            k for k, q in self._queues.items() if len(q) >= self.policy.max_batch
        ]

    def due_keys(self, now: float) -> list[tuple]:
        """Buckets that must flush at ``now``: full, or oldest waited out."""
        return [
            k
            for k, q in self._queues.items()
            if q and (len(q) >= self.policy.max_batch or now >= self.deadline(k))
        ]

    def pop(self, key: tuple) -> list[PendingRequest]:
        """Dequeue up to ``max_batch`` requests from one bucket, FIFO."""
        q = self._queues[key]
        out = [q.popleft() for _ in range(min(len(q), self.policy.max_batch))]
        return out
