"""Real-clock async serving driver over the sans-IO `AllocService`.

Counterpart of `repro.serve.driver`. `AllocService` is deliberately IO-free:
it owns queues, the solver cache and flush policy, but never reads a clock
or spawns a thread. This module is the real-clock front-end: the piece that
serves a *concurrent* request stream the way a FedSem base station would
re-solve eq. 13 online:

Thread topology (two roles, N callers + 1 solver):

    caller threads              solver thread (owns the service)
    --------------              --------------------------------
    submit():                   loop:
      service.prepare()  ──┐      wait on admission queue, with a timeout
      (pads on the         │      that expires at the earliest bucket
       caller's thread)    │      deadline (the `flush_due` timer)
                           ├──►   admit everything queued (cheap appends)
                           │      service.flush_due(now)  [full OR expired]
                           │      resolve futures
      bounded queue.put() ─┘    on close(): drain queue, service.drain()

* The **admission path** runs on the caller's thread: `AllocService.prepare`
  does the padding/canonicalisation work there. The port's solver is a
  host-bound loop of eager torch launches that holds the GIL most of the
  time, so callers interleave with it at the interpreter's switch interval
  rather than overlapping it: real-clock latencies and makespans show it,
  answers do not. The prepared request then enters a **bounded** admission
  queue — when the solver falls behind, `submit` blocks (backpressure) or
  raises `AdmissionQueueFull`, it never grows memory without bound.
* The **solver thread** is the only thread that mutates the service, so the
  virtual-clock `run_load` and this driver exercise *byte-identical* policy
  code single-threaded — the equivalence contract (same stream => same
  hardened X per request) holds by construction, not by luck
  (`tests/test_torch_serve_driver.py` asserts it).
* The **timer** is the solver loop's queue timeout: it wakes exactly at the
  next `MicroBatcher` deadline and fires `flush_due`, so max-wait flushes
  happen on time even when no new request arrives.
* `close()` performs a graceful **drain**: admission is fenced off, whatever
  is still queued is admitted, and `service.drain` flushes every bucket
  before the thread exits — no submitted request is ever dropped.

An optional `LadderLearner` observes every admitted (N, K); `refit()` swaps
the service's bucket ladder in place between epochs (safe mid-stream, see
`AllocService.set_buckets`). With ``DriverConfig.refit_waste_threshold`` set,
the solver thread also *auto*-refits: every ``refit_check_every`` admissions
it scores the observed shape mix's padded-area waste under the service's
current ladder and refits when the mix has drifted past the threshold — a
time-correlated workload (the ``gauss_markov`` scenario stream) shifts its
shape mix mid-run, and the ladder follows without an operator hook. Swapping
ladders mid-stream cannot change answers: padding is answer-transparent
(identical hardened X through any covering bucket), so the real==virtual
equivalence gate holds across refits.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import NamedTuple

import torch

from ..core import SystemParams, Weights
from .ladder import LadderLearner, LadderSnapshot
from .service import AllocService, Completion

_SENTINEL = object()


def pace_stream(
    driver: "RealClockDriver", requests, schedule, weights=None
) -> tuple[list[Future], float]:
    """Replay a request stream against the real clock: submit ``requests[i]``
    at offset ``schedule[i]`` seconds from the call (sleeping on the caller
    thread between arrivals, i.e. this thread IS the arrival process).
    Returns (futures in submission order, the driver-clock start offset) —
    makespan is ``driver.now() - t0`` once the stream is drained. Shared by
    `launch.serve_alloc --driver real` and `chip_smoke.py`."""
    requests = list(requests)
    schedule = list(schedule)
    # fail before pacing starts, not with an IndexError (weights) or a
    # silently zip-truncated stream (schedule) mid-run
    if len(schedule) != len(requests):
        raise ValueError(
            f"schedule ({len(schedule)}) and requests ({len(requests)}) differ"
        )
    if weights is not None and len(weights) != len(requests):
        raise ValueError(
            f"weights ({len(weights)}) and requests ({len(requests)}) differ"
        )
    t0 = driver.now()
    futures = []
    for i, (params, t_arr) in enumerate(zip(requests, schedule)):
        lag = t0 + float(t_arr) - driver.now()
        if lag > 0:
            time.sleep(lag)
        futures.append(
            driver.submit(params, weights[i] if weights is not None else None)
        )
    return futures, t0


def same_hardened_assignments(a, b) -> bool:
    """THE driver equivalence predicate: two completion streams answered the
    same requests with identical hardened assignments (req_id -> exact X).

    This is what "the real-clock driver == the virtual-clock loadgen" means
    everywhere it is gated (`tests/test_torch_serve_driver.py`,
    `serve_alloc --driver real --smoke`, `chip_smoke.py`): completion ORDER
    may differ (real timing moves batch boundaries), the answers may not.
    """
    xa = {c.req_id: c.alloc.X.cpu() for c in a}
    xb = {c.req_id: c.alloc.X.cpu() for c in b}
    return sorted(xa) == sorted(xb) and all(
        xa[i].shape == xb[i].shape and torch.equal(xa[i], xb[i]) for i in xa
    )


class AdmissionQueueFull(RuntimeError):
    """The bounded admission queue is full and the driver was configured (or
    timed out) not to wait — the caller should shed or retry (backpressure)."""


class DriverClosed(RuntimeError):
    """submit() after close(): the driver is draining or drained."""


class DriverConfig(NamedTuple):
    """Real-clock driver knobs (the batching policy itself lives in
    `ServeConfig` — this only shapes the IO front-end)."""

    #: admission-queue bound: max prepared requests waiting for the solver
    #: thread; the backpressure surface
    queue_capacity: int = 256
    #: True: submit() blocks while the queue is full (up to
    #: ``submit_timeout_s``); False: a full queue raises immediately
    block: bool = True
    #: max seconds submit() may block on a full queue (None = forever);
    #: expiry raises `AdmissionQueueFull`
    submit_timeout_s: float | None = None
    #: solver-thread wake-up interval while fully idle (no pending requests,
    #: nothing queued); bounds close() latency, not correctness
    idle_poll_s: float = 0.05
    #: how many recent Completions ``driver.completions`` retains (None =
    #: unbounded). Bounded by default for the same reason the metrics
    #: reservoirs are: an indefinitely running driver must not grow
    #: per-request state — callers get every answer through their Future
    completion_log: int | None = 4096
    #: auto-refit trigger: when a `LadderLearner` is attached and the
    #: observed mix's relative padded-area waste under the service's CURRENT
    #: ladder exceeds this, the solver thread refits and swaps the ladder
    #: (None = manual ``driver.refit()`` only). An uncoverable shape scores
    #: the current ladder inf, so drift into unserved sizes always trips it
    refit_waste_threshold: float | None = None
    #: admissions between drift checks (amortises the waste rescore)
    refit_check_every: int = 64
    #: observations required before the first auto-refit may fire (early
    #: tiny mixes look maximally skewed; don't thrash the solver cache)
    refit_min_samples: int = 32


class RealClockDriver:
    """Threaded real-clock front-end over one `AllocService` (module doc).

    Usage::

        service = AllocService(cfg)
        service.warmup(example_stream)
        with RealClockDriver(service) as driver:
            futures = [driver.submit(p) for p in stream]   # any thread(s)
            answers = [f.result(timeout=60) for f in futures]
        # `with` exit == driver.close(): drains everything, joins the thread

    ``submit`` returns a `concurrent.futures.Future` resolving to the
    request's `Completion`. Completion order is also recorded in
    ``driver.completions``. All service timestamps are seconds on a
    monotonic clock starting ~0 at driver construction, so metric summaries
    read like the virtual-clock ones.
    """

    def __init__(
        self,
        service: AllocService,
        cfg: DriverConfig = DriverConfig(),
        ladder: LadderLearner | None = None,
        start: bool = True,
    ):
        self.service = service
        self.cfg = cfg
        self.ladder = ladder
        self._t0 = time.monotonic()
        self._inbox: queue.Queue = queue.Queue(maxsize=cfg.queue_capacity)
        self._tickets: dict[int, Future] = {}     # solver-thread only
        #: most recent completions in completion order (bounded by
        #: ``cfg.completion_log``; every completion also resolves its Future)
        self.completions: deque[Completion] = deque(maxlen=cfg.completion_log)
        #: auto-refit bookkeeping (solver-thread only): admissions seen, the
        #: admission count that triggers the next drift check, refits fired
        self._admitted = 0
        self._next_refit_check = cfg.refit_check_every
        self.auto_refits = 0
        self._closed = threading.Event()
        #: serialises the closed-check-then-enqueue in submit() against
        #: close()'s fence + post-join sweep, so an admission can never land
        #: in the inbox after the final drain (it either precedes the
        #: sentinel or raises DriverClosed)
        self._fence = threading.Lock()
        self._error: BaseException | None = None
        self._started = False
        self._thread = threading.Thread(
            target=self._run, name="alloc-driver-solver", daemon=True
        )
        if start:
            self.start()

    # -- caller-thread API ---------------------------------------------------

    def now(self) -> float:
        """Seconds since driver construction (the clock all service
        timestamps use)."""
        return time.monotonic() - self._t0

    def submit(
        self,
        params: SystemParams,
        weights: Weights | None = None,
        warm_start=None,
        accuracy=None,
        tenant=None,
    ) -> Future:
        """Admit one scenario from any thread; returns a Future resolving to
        its `Completion`.

        Pads/canonicalises on THIS thread (overlapping any running solve),
        then enqueues on the bounded admission queue: blocks under
        backpressure when ``cfg.block`` (up to ``cfg.submit_timeout_s``),
        else raises `AdmissionQueueFull`. ``warm_start`` optionally injects
        explicit warm-start entry/entries (`serve.warmstart.CacheEntry` or a
        tuple of them), overriding any cache lookup — round-to-round reuse
        and the replay gate use this; normal serving leaves it None and lets
        the service's cache attach hits.
        ``accuracy``/``tenant`` select the A(rho) fit the request is stamped
        with at prepare (`AllocService._resolve_accuracy`): per-tenant FL
        jobs sharing this driver pass their tenant id so refits never touch
        a co-tenant's requests.
        """
        if self._closed.is_set():
            raise DriverClosed("driver is closed; no further admissions")
        prepared = self.service.prepare(params, weights, warm_start, accuracy, tenant)
        fut: Future = Future()
        # re-check + enqueue under the fence: close() flips the flag under
        # the same lock, so a submit that slept through close() during the
        # prepare() above raises here instead of enqueueing into a queue
        # nobody will ever drain again. Backpressure blocking happens inside
        # the fence too, which serialises blocked submitters — fine, they
        # were going to wait for the same solver anyway.
        with self._fence:
            if self._closed.is_set():
                raise DriverClosed("driver is closed; no further admissions")
            try:
                self._inbox.put(
                    (prepared, fut, self.now()),
                    block=self.cfg.block,
                    timeout=self.cfg.submit_timeout_s,
                )
            except queue.Full:
                raise AdmissionQueueFull(
                    f"admission queue full ({self.cfg.queue_capacity} waiting); "
                    "solver thread is behind — shed load or retry"
                ) from None
        if self.ladder is not None:
            # observe only ADMITTED shapes (after the put): shed/rejected
            # submits must not skew the learned mix toward traffic that was
            # never served
            self.ladder.observe(params.N, params.K)
        return fut

    def _cover_must_fit(self, must_fit) -> tuple[tuple[int, int], ...]:
        """Union ``must_fit`` with the current ladder's cover shape so a refit
        never shrinks coverage: any request admissible before the swap stays
        admissible after it. Without this, a refit racing in-flight submitters
        can learn a ladder from only the shapes observed SO FAR and a
        concurrent admission of a not-yet-observed (but previously covered)
        shape fails prepare with "no bucket fits"."""
        current = self.service.cfg.buckets
        if not current:
            return tuple(must_fit)
        cover = (max(b.N for b in current), max(b.K for b in current))
        return tuple(must_fit) + (cover,)

    def refit(self, must_fit=()) -> LadderSnapshot:
        """Re-learn the bucket ladder from the shapes observed so far and
        swap it into the service (between-epochs hook; requires a
        `LadderLearner`). Safe while serving: queued requests keep their
        admitted buckets, new admissions pad into the refit ladder, and the
        learned ladder always retains the current ladder's cover shape so
        racing submitters of not-yet-observed shapes stay admissible."""
        if self.ladder is None:
            raise RuntimeError("RealClockDriver was built without a LadderLearner")
        snap = self.ladder.refit(must_fit=self._cover_must_fit(must_fit))
        # NamedTuple._replace-based swap is a single attribute store =>
        # atomic under the GIL; prepare() on caller threads sees either
        # ladder, and both pad into valid, solvable buckets
        self.service.set_buckets(snap.buckets)
        return snap

    def _maybe_auto_refit(self) -> None:
        """Solver-thread drift check (see `DriverConfig.refit_waste_threshold`):
        every ``refit_check_every`` admissions, score the observed mix's waste
        under the service's current ladder and refit when it drifts past the
        threshold. A refit that learns the same ladder back skips the swap so
        a stable-but-wasteful mix triggers at most one solver-cache churn.
        """
        cfg = self.cfg
        if (
            self.ladder is None
            or cfg.refit_waste_threshold is None
            or self._admitted < self._next_refit_check
        ):
            return
        current = self.service.cfg.buckets
        if current is None:
            return                      # exact-shape service: nothing to swap
        counts = self.ladder.counts()
        if sum(counts.values()) < cfg.refit_min_samples:
            # observe() runs on caller threads after the enqueue, so counts
            # can trail admissions; retry next loop instead of consuming the
            # check (bumping here could skip the only drift check a short
            # stream ever gets)
            return
        self._next_refit_check = self._admitted + cfg.refit_check_every
        waste = LadderLearner._waste_or_inf(counts, current)
        if waste > cfg.refit_waste_threshold:
            snap = self.ladder.refit(must_fit=self._cover_must_fit(()))
            if tuple(snap.buckets) != tuple(current):
                self.service.set_buckets(snap.buckets)
                self.auto_refits += 1

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self, timeout: float | None = None) -> None:
        """Graceful shutdown: fence off admission, drain the queue AND every
        bucket, resolve all futures, join the solver thread. Idempotent.
        Raises TimeoutError if the drain outlives ``timeout`` seconds, and
        re-raises (wrapped) any error that killed the solver thread.

        Note: a submit() parked on a full queue with no running solver
        (``start=False`` + ``block=True`` + no ``submit_timeout_s``) holds
        the admission fence and would block close(); give blocking submits a
        timeout or start the solver before closing in that configuration."""
        with self._fence:
            first = not self._closed.is_set()
            self._closed.set()
        if not self._started:
            # never-started driver (e.g. backpressure tests): drain inline
            self._admit_pending()
            self._resolve(self.service.drain(self.now())[0])
            return
        if first:
            # sentinel after the flag: admissions racing close() either raise
            # or land before the sentinel and are drained below
            self._inbox.put(_SENTINEL)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"driver drain did not finish within {timeout}s")
        if self._error is not None:
            self._fail_inflight(self._error)   # catch post-death stragglers
            raise RuntimeError(
                "driver solver thread died; in-flight requests were failed"
            ) from self._error
        # post-join sweep: submit() only enqueues under the fence after
        # re-checking the closed flag, so with the flag set and the thread
        # joined the inbox is final — catch any admission that slipped in
        # between the solver's last drain and its exit
        with self._fence:
            if self._admit_pending() or self.service.pending():
                self._resolve(self.service.drain(self.now())[0])

    def __enter__(self) -> "RealClockDriver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def summary(self) -> dict:
        """Service metrics plus driver-level admission stats (and warm-start
        cache accounting when the service runs one)."""
        out = {
            **self.service.metrics.summary(),
            "queue_capacity": self.cfg.queue_capacity,
            "inflight": len(self._tickets),
            "auto_refits": self.auto_refits,
        }
        if self.service.warm_cache is not None:
            out.update(self.service.warm_cache.stats())
        return out

    # -- solver thread -------------------------------------------------------

    def _admit_one(self, item) -> bool:
        """Admit one inbox item; True if it was the shutdown sentinel."""
        if item is _SENTINEL:
            return True
        prepared, fut, t_enq = item
        req_id = self.service.admit(prepared, now=t_enq)
        self._tickets[req_id] = fut
        self._admitted += 1
        return False

    def _admit_pending(self) -> bool:
        """Drain the inbox without blocking; True if a sentinel was seen."""
        stop = False
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                return stop
            stop = self._admit_one(item) or stop

    def _resolve(self, done: list[Completion]) -> None:
        for c in done:
            self.completions.append(c)
            fut = self._tickets.pop(c.req_id, None)
            if fut is not None:
                fut.set_result(c)

    def _run(self) -> None:
        try:
            self._serve_loop()
        except BaseException as exc:  # never die silently: fail the futures
            # under the fence: a submit() is either mid-put (we wait, then
            # sweep its item) or will re-check the closed flag and raise —
            # no future can be orphaned in the inbox after this handler
            with self._fence:
                self._error = exc
                self._closed.set()    # fence off new admissions
                self._fail_inflight(exc)

    def _serve_loop(self) -> None:
        svc = self.service
        stop = False
        while not stop:
            # the flush_due timer: sleep on the inbox until the earliest
            # bucket deadline (or an idle poll when nothing is pending)
            deadline = svc.next_deadline()
            timeout = (
                self.cfg.idle_poll_s
                if deadline is None
                else max(0.0, deadline - self.now())
            )
            try:
                stop = self._admit_one(self._inbox.get(timeout=timeout))
            except queue.Empty:
                pass
            # burst admission: everything already queued joins this round's
            # flush decision before any solve starts
            stop = self._admit_pending() or stop
            if stop:
                break
            self._maybe_auto_refit()
            done, _ = svc.flush_due(now=self.now())
            self._resolve(done)
        # graceful drain: late admissions that beat the fence, then flush
        # every bucket regardless of fill or deadline
        self._admit_pending()
        self._resolve(svc.drain(now=self.now())[0])

    def _fail_inflight(self, exc: BaseException) -> None:
        """Solver thread died: propagate ``exc`` to every unresolved future
        (admitted or still queued) so no caller hangs on result(); close()
        re-raises the error to the shutdown path."""
        for fut in self._tickets.values():
            if not fut.done():
                fut.set_exception(exc)
        self._tickets.clear()
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                return
            if item is not _SENTINEL:
                _prepared, fut, _t = item
                if not fut.done():
                    fut.set_exception(exc)
