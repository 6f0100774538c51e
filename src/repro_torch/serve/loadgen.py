"""Poisson-arrival load generator for `AllocService` (virtual-clock DES).

Counterpart of `repro.serve.loadgen`; arrivals come from a
`torch.Generator` (an int seed or a generator), which draws the
reference's law (exponential gaps at the rate), not its numbers.

Arrivals happen on a *virtual* clock (exponential inter-arrival gaps at a
target rate); solves consume *measured* wall-clock seconds on that same
clock. This hybrid discrete-event simulation gives reproducible arrival
patterns while charging the service its true compute cost — so throughput
and tail latency are honest, but a 100 req/s experiment doesn't need 100
real req/s of wall time.

Event loop semantics (single server): the next event is either the next
arrival or the earliest bucket deadline; a size-triggered flush runs
immediately after the admitting arrival; while a batch solves, the clock
advances by the measured solve time, so requests arriving "during" a solve
accrue queue wait exactly as they would against a busy real server.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import SystemParams, Weights
from ..scenarios import generator, get_family
from .service import AllocService, Completion


def poisson_arrivals(seed, n: int, rate_hz: float) -> np.ndarray:
    """n arrival times (seconds, ascending) of a Poisson process at rate_hz;
    ``seed`` is an int or a CPU `torch.Generator` (arrivals are host times)."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    gen = generator(seed, "cpu")
    gaps = torch.empty(n, dtype=torch.float64).exponential_(generator=gen).numpy()
    return np.cumsum(gaps / rate_hz)


def scenario_stream(
    seed, n: int, *, scenario: str = "iid_rayleigh", **kwargs
) -> list[SystemParams]:
    """Request stream drawn from a registered scenario family by name.

    Thin resolver over ``get_family(scenario).stream`` so serving callers
    (the CLI, `chip_smoke.py`) pick the workload with a string. Stateful
    families (``gauss_markov``) return time-correlated traces; the default
    redraws i.i.d. per request. ``device`` goes through ``kwargs`` (the
    card unless ``device="cpu"``).
    """
    return get_family(scenario).stream(seed, n, **kwargs)


class LoadResult(NamedTuple):
    completions: list          # list[Completion], completion order
    throughput_rps: float      # completed / makespan
    makespan_s: float          # first arrival -> last completion (virtual)
    busy_s: float              # total solve wall time charged to the clock
    summary: dict              # ServiceMetrics.summary() snapshot


def run_load(
    service: AllocService,
    requests: list[SystemParams],
    arrivals,
    weights: list[Weights] | None = None,
    warm_starts: list | None = None,
    accuracies: list | None = None,
    tenants: list | None = None,
) -> LoadResult:
    """Drive ``service`` with ``requests[i]`` arriving at ``arrivals[i]``.

    Returns every completion (the run always drains). ``weights`` optionally
    carries per-request objective weights; ``warm_starts`` optionally injects
    explicit warm-start entries per request (None entries stay cold) — this
    is how a virtual replay reproduces a real-clock warm run exactly: cache
    contents are timing-dependent, so the replay re-injects the RECORDED
    `Completion.warm_start` entries instead of relying on its own cache.
    ``accuracies``/``tenants`` optionally carry each request's A(rho) fit or
    tenant id (`AllocService.prepare` resolution) so a mixed-tenant stream —
    e.g. one recorded off a multi-job driver — replays each request under
    the same belief it was originally solved with.
    """
    if len(requests) != len(arrivals):
        raise ValueError(
            f"requests ({len(requests)}) and arrivals ({len(arrivals)}) differ"
        )
    if weights is not None and len(weights) != len(requests):
        # fail at admission, not with an IndexError mid-run
        raise ValueError(
            f"weights ({len(weights)}) and requests ({len(requests)}) differ"
        )
    if warm_starts is not None and len(warm_starts) != len(requests):
        raise ValueError(
            f"warm_starts ({len(warm_starts)}) and requests ({len(requests)}) differ"
        )
    if accuracies is not None and len(accuracies) != len(requests):
        raise ValueError(
            f"accuracies ({len(accuracies)}) and requests ({len(requests)}) differ"
        )
    if tenants is not None and len(tenants) != len(requests):
        raise ValueError(
            f"tenants ({len(tenants)}) and requests ({len(requests)}) differ"
        )
    arrivals = [float(t) for t in arrivals]
    if any(b < a for a, b in zip(arrivals, arrivals[1:])):
        raise ValueError("arrivals must be non-decreasing")

    clock = 0.0
    busy_total = 0.0
    completions: list[Completion] = []
    i, n = 0, len(requests)

    def admit_through(t: float) -> int:
        """Admit every arrival with t_arr <= t; returns the new stream index.

        Arrivals are physical events: everything with t_arr <= clock already
        happened (possibly while the server was busy solving) and must be in
        the queues before any flush decision at `clock` — including arrivals
        landing *exactly* on a bucket deadline (regression: the deadline
        branch used to flush first, so a tied arrival missed its batch).
        """
        nonlocal i
        while i < n and arrivals[i] <= t:
            service.submit(
                requests[i],
                weights[i] if weights is not None else None,
                now=arrivals[i],
                warm_start=warm_starts[i] if warm_starts is not None else None,
                accuracy=accuracies[i] if accuracies is not None else None,
                tenant=tenants[i] if tenants is not None else None,
            )
            i += 1
        return i

    while i < n or service.pending() > 0:
        admit_through(clock)
        # full buckets flush first — at saturation this is what fills batches
        done, busy = service.flush_full(now=clock)
        if not done:
            deadline = service.next_deadline()
            t_arr = arrivals[i] if i < n else None
            if deadline is not None and (t_arr is None or deadline <= t_arr):
                clock = max(clock, deadline)
                # an arrival tied with the deadline (t_arr == clock) belongs
                # in the queues before the flush decision at `clock`
                admit_through(clock)
                done, busy = service.flush_due(now=clock)
            elif t_arr is not None:
                clock = max(clock, t_arr)   # idle until the next arrival
                continue
        completions.extend(done)
        clock += busy
        busy_total += busy

    makespan = max((clock - arrivals[0]), 1e-12) if arrivals else 0.0
    return LoadResult(
        completions=completions,
        throughput_rps=len(completions) / makespan if makespan else 0.0,
        makespan_s=makespan,
        busy_s=busy_total,
        summary=service.metrics.summary(),
    )
