"""Learned bucket ladders: fit `ShapeBucket` sets to an observed shape mix.

Counterpart of `repro.serve.ladder` (plain Python; the port keeps its own
copy, so the same histogram learns the same ladder in both packages).

`DEFAULT_BUCKETS` is a hand-picked geometric grid; a real deployment sees a
*specific* (N, K) distribution drawn from its device fleet, and every padded
slot it never needed is wasted solve time (cost scales with the padded area
N_pad x K_pad, not the real one). This module learns a replacement ladder
from a shape histogram:

    minimise   E_{(n,k) ~ mix}[ area(bucket_for(n, k, L)) - n*k ]
    over       ladders L with |L| <= max_buckets covering every shape

i.e. expected padded-area waste under EXACTLY the assignment rule the
service uses (`bucket_for`: smallest-area covering bucket). Fewer buckets is
also better on a second axis — each bucket is one bound solver in the
`AllocService` cache — which is why ``max_buckets`` is a hard budget.

The optimiser is greedy set-augmentation over the finite candidate grid
``{(n_i, k_j)}`` of observed shape coordinates (an optimal ladder only needs
those: shrinking any bucket to the componentwise max of the shapes it serves
never increases waste and never breaks coverage):

1. seed with the must-have cover bucket ``(max n, max k)``;
2. repeatedly add the candidate that most reduces expected waste;
3. stop at ``max_buckets`` or when no candidate strictly improves.

Each step re-scores the full histogram exactly, so the result is monotone in
the budget and exact whenever one bucket per distinct shape fits the budget
(waste 0 on the observed mix). `LadderLearner` wraps this in a thread-safe
accumulator with the ``refit`` hook the real-clock driver calls between
epochs (`AllocService.set_buckets` makes the swap safe mid-stream).
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Iterable, Mapping, NamedTuple

from ..core.types import DEFAULT_BUCKETS, ShapeBucket, bucket_for

#: matches DEFAULT_BUCKETS' cache footprint: a learned ladder should beat the
#: default on waste without holding more solvers
DEFAULT_MAX_BUCKETS = len(DEFAULT_BUCKETS)


def _as_counts(shapes) -> Counter:
    """Normalise ``shapes`` — an iterable of (n, k) or a {(n, k): count}
    mapping — into a validated Counter."""
    counts = Counter(dict(shapes.items()) if isinstance(shapes, Mapping) else list(shapes))
    if not counts:
        raise ValueError("need at least one observed (n, k) shape")
    for (n, k), c in counts.items():
        if c <= 0:
            raise ValueError(f"shape ({n}, {k}) has non-positive count {c}")
        if n < 1 or k < n:
            raise ValueError(
                f"observed shape (N={n}, K={k}) violates K >= N >= 1 "
                "(the SystemParams contract)"
            )
    return counts


def padded_area_waste(shapes, buckets: Iterable[ShapeBucket]) -> float:
    """Expected *relative* padded-area waste of a ladder on a shape mix:
    ``E[area(bucket) - n*k] / E[n*k]`` under `bucket_for` assignment
    (0 = every shape lands in an exactly-fitting bucket).

    Raises (via `bucket_for`) if some observed shape fits no bucket, so a
    candidate ladder is validated and scored in one call.
    """
    counts = _as_counts(shapes)
    buckets = tuple(buckets)
    pad_area = real_area = 0.0
    for (n, k), c in counts.items():
        pad_area += c * bucket_for(n, k, buckets).area
        real_area += c * n * k
    return pad_area / real_area - 1.0


def learn_buckets(
    shapes,
    max_buckets: int = DEFAULT_MAX_BUCKETS,
    must_fit: Iterable[tuple[int, int]] = (),
) -> tuple[ShapeBucket, ...]:
    """Greedy expected-waste-minimising ladder for a shape mix (see module
    docstring). ``shapes`` is an iterable of (n, k) or a {(n, k): count}
    histogram; ``must_fit`` optionally adds zero-count shapes the ladder must
    cover anyway (e.g. a size the operator knows is coming). Returns buckets
    sorted ascending by (area, N) — a drop-in for ``ServeConfig.buckets``.
    """
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    counts = _as_counts(shapes)
    cover = Counter(counts)
    for n, k in must_fit:
        if n < 1 or k < n:            # same contract as observed shapes
            raise ValueError(
                f"must_fit shape (N={n}, K={k}) violates K >= N >= 1"
            )
        cover.setdefault((n, k), 0)   # coverage constraint, no waste weight

    ns = sorted({n for n, _ in cover})
    ks = sorted({k for _, k in cover})
    # candidate buckets: the observed coordinate grid (k >= n is the
    # ShapeBucket contract; a candidate violating it covers no valid shape
    # that a (n', k') with k' >= n' wouldn't cover at <= area)
    candidates = {ShapeBucket(n, k) for n in ns for k in ks if k >= n}
    seed = ShapeBucket(max(ns), max(ks))   # covers everything (max k >= max n)
    chosen = {seed}
    candidates.discard(seed)

    # incremental greedy: track each weighted shape's current padded area
    # under `chosen` (assignment = smallest covering area, i.e. `bucket_for`
    # minus its waste-irrelevant N tie-break). Adding candidate c re-assigns
    # exactly the shapes it fits with a smaller area, so its waste reduction
    # is sum(count * (cur_area - c.area)) over those — O(|shapes|) per
    # candidate instead of re-scoring the whole histogram through bucket_for
    # (fleet-sized mixes make the naive rescore minutes per refit).
    weighted = [(n, k, c) for (n, k), c in counts.items() if c]
    cur = {(n, k): seed.area for n, k, _ in weighted}

    def gain(cand: ShapeBucket) -> float:
        g = 0.0
        for n, k, c in weighted:
            if cand.fits(n, k) and cand.area < cur[(n, k)]:
                g += c * (cur[(n, k)] - cand.area)
        return g

    best = sum(c * (seed.area - n * k) for n, k, c in weighted)
    while len(chosen) < max_buckets and candidates and best > 0.0:
        pick, picked_gain = None, 0.0
        # deterministic scan order (sets hash-shuffle): equal-gain ties go to
        # the smallest-area candidate, so refits are reproducible run-to-run
        for cand in sorted(candidates, key=lambda b: (b.area, b.N)):
            g = gain(cand)
            if g > picked_gain:
                pick, picked_gain = cand, g
        if pick is None:
            break                      # no candidate strictly improves
        chosen.add(pick)
        candidates.discard(pick)
        best -= picked_gain
        for n, k, _ in weighted:
            if pick.fits(n, k) and pick.area < cur[(n, k)]:
                cur[(n, k)] = pick.area
    return tuple(sorted(chosen, key=lambda b: (b.area, b.N)))


class LadderSnapshot(NamedTuple):
    """One `LadderLearner.refit` result, with its predicted waste."""

    buckets: tuple[ShapeBucket, ...]
    waste: float               # padded_area_waste of `buckets` on the mix
    baseline_waste: float      # same mix under the learner's fallback ladder
    n_observed: int


class LadderLearner:
    """Accumulates the observed (N, K) mix and refits a bucket ladder on
    demand — the autoscaling half of the serving front-end.

    ``observe`` is thread-safe (the driver calls it from caller threads on
    every admission); ``refit`` greedily re-learns a ladder from the counts
    so far and returns a `LadderSnapshot`, falling back to ``fallback``
    (default `DEFAULT_BUCKETS`) until ``min_samples`` shapes have been seen.
    The learned ladder always additionally covers every ``fallback`` shape
    region's observed shapes by construction (it is fit on observations), but
    NOT unseen future shapes — pass ``must_fit`` shapes to `refit` or keep a
    headroom bucket in mind if the mix can grow.
    """

    def __init__(
        self,
        max_buckets: int = DEFAULT_MAX_BUCKETS,
        min_samples: int = 1,
        fallback: tuple[ShapeBucket, ...] = DEFAULT_BUCKETS,
    ):
        self.max_buckets = max_buckets
        self.min_samples = min_samples
        self.fallback = tuple(fallback)
        self._counts: Counter = Counter()
        self._lock = threading.Lock()

    def observe(self, n: int, k: int, count: int = 1) -> None:
        """Record ``count`` arrivals of an exact (n, k) scenario shape."""
        if count <= 0:
            # a zero/negative entry would poison the histogram and make a
            # later refit() raise from _as_counts instead of returning
            raise ValueError(f"observe count must be >= 1, got {count}")
        with self._lock:
            self._counts[(int(n), int(k))] += count

    @property
    def n_observed(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def counts(self) -> dict:
        """Snapshot of the observed {(n, k): count} histogram."""
        with self._lock:
            return dict(self._counts)

    def refit(self, must_fit: Iterable[tuple[int, int]] = ()) -> LadderSnapshot:
        """Learn a fresh ladder from everything observed so far."""
        counts = self.counts()
        n_obs = sum(counts.values())
        # the fallback ladder may not cover every observed shape (that can be
        # exactly why a learner is in play) — score it as inf, don't crash
        base_waste = self._waste_or_inf(counts, self.fallback)
        if n_obs < self.min_samples:
            return LadderSnapshot(
                buckets=self.fallback,
                waste=base_waste,
                baseline_waste=base_waste,
                n_observed=n_obs,
            )
        buckets = learn_buckets(counts, self.max_buckets, must_fit=must_fit)
        return LadderSnapshot(
            buckets=buckets,
            waste=padded_area_waste(counts, buckets),
            baseline_waste=base_waste,
            n_observed=n_obs,
        )

    @staticmethod
    def _waste_or_inf(counts, buckets) -> float:
        """`padded_area_waste`, but uncoverable mixes score inf (a ladder
        that cannot serve the mix is infinitely wasteful, not an error) and
        an empty mix scores nan."""
        if not counts:
            return float("nan")
        try:
            return padded_area_waste(counts, buckets)
        except ValueError:
            return float("inf")
