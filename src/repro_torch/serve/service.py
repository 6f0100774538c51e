"""`AllocService`: micro-batched scenario-allocation serving over `solve_batch`.

Counterpart of `repro.serve.service`. Heterogeneous `SystemParams` requests
are padded into canonical `ShapeBucket`s (`pad_params` masks keep padding
inert), queued per bucket, and flushed through ONE bound solver per
(bucket, batch slots, `AllocatorConfig`, mesh). The batch axis is padded to
a fixed number of slots by replicating the last request, so each bucket's
solver always sees one batch shape however full its flushes run.

The reference's cache of AOT-compiled executables (``lower(...).compile()``)
is here a cache of bound solver callables under the same keys: the cold
`solve_batch` per (bucket, slots, config, mesh), and the warm-refine pass
(`core.allocator.refine_with_start`) under the same key plus
``("warm-refine", n_cand)``. A callable's first call builds what it needs
(the objective kernel's library, on first use), so the cache's
``compile_s`` is the time of each key's first call. `executables` stays a
readable dict, shareable between services with the same config.

Equivalence guarantees this layer keeps (tests/test_torch_serving.py):
a padded-bucket solve returns the same hardened assignment as the
exact-shape solve; batch-axis padding replicates the tail request, whose
replicas are solved and discarded; rows are independent, so co-batching
never changes any caller's answer. Each flushed batch is scored by
`core.scoring.batch_objectives` in one call over the padded batch (one
launch of the objective kernel on the card): `Completion.objective` is the
eq. 13 value of the returned allocation, equal to `system.objective` on the
exact-shape scenario to float32 round-off. With
``AllocatorConfig(use_kernel_objective=False)`` the flush is scored by the
plain version too, so that path launches no kernel.

The A(rho) accuracy model is per request: every request is stamped with its
own `AccuracyFn` at `prepare` (explicit ``accuracy=`` > per-tenant registry
> the service default), the flush stacks the per-row fits (`stack_accuracy`)
and solves and scores with ``acc_batched=True``, so co-batched tenants never
see each other's model and a refit changes no cache key.

With ``ServeConfig(shard_batch=True)`` the batch axis shards over a
scenario mesh (`core.distribute`; every CUDA device by default): a bucket
fills ``len(mesh) x max_batch`` slots, each device solves ``max_batch`` of
them, the answers come back to the service's device, and the mesh is part
of every cache key.

The service is sans-IO: callers pass ``now`` timestamps and decide when to
flush (`flush_full` after submits, `flush_due` on timer ticks, `drain` at
shutdown), so a real clock (`serve.driver`) or a virtual one
(`serve.loadgen`) can drive it. Its tensors live on ``device`` (the card
unless the caller passes ``device="cpu"``); a flush's ``solve_s`` ends in a
synchronize of that device.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import (
    Allocation,
    AllocatorConfig,
    SystemParams,
    Weights,
    bucket_for,
    pad_params,
    stack_params,
    stack_weights,
    tree_index,
    unpad_alloc,
)
from ..core.accuracy import AccuracyFn, default_accuracy, stack_accuracy
from ..core.allocator import refine_with_start, solve_batch
from ..core.distribute import round_up, scenario_mesh
from ..core.scoring import batch_objectives
from ..core.types import DEFAULT_BUCKETS, ShapeBucket
from ..device import resolve_device
from .batching import BatchPolicy, MicroBatcher, PendingRequest
from .metrics import ServiceMetrics
from .warmstart import (
    CacheEntry,
    WarmStartCache,
    WarmStartConfig,
    batch_starts,
    entry_from_alloc,
    iters_to_converge,
    request_signature,
)


class ServeConfig(NamedTuple):
    policy: BatchPolicy = BatchPolicy()
    #: bucket ladder; None = exact shapes (no padding: every distinct
    #: request shape gets its own solver; the solve-per-request baseline)
    buckets: tuple[ShapeBucket, ...] | None = DEFAULT_BUCKETS
    allocator: AllocatorConfig = AllocatorConfig(inner="pgd")
    #: pad the batch axis to ``policy.max_batch`` slots so each bucket's
    #: solver sees one batch shape; False follows the observed batch size
    pad_batch: bool = True
    #: shard the batch axis over a scenario mesh (`core.distribute`): a
    #: bucket's flush fills ``len(mesh) x policy.max_batch`` slots and each
    #: device solves ``max_batch`` of them
    shard_batch: bool = False
    #: score every flushed bucket batch in one `batch_objectives` call and
    #: report the eq. 13 value on each `Completion.objective`
    score_objective: bool = True
    #: warm-start solution-reuse cache (`serve.warmstart`); None disables it
    #: (the cold path, bit for bit)
    warmstart: WarmStartConfig | None = None


def _round_sig(x: float, digits: int = 12) -> float:
    """Round to ``digits`` significant figures (canonical bucket-key floats).

    Requests built from the same per-subcarrier bandwidth but different K
    reconstruct the padded ``B = bbar * K_pad`` through different float
    round-trips and can disagree by an ulp; keyed raw, they would land in
    different queues (and `stack_params` would reject mixing them). 12
    significant figures absorb ulp noise (~1e-16 rel) while keeping any
    physically distinct bandwidth (>= 1e-10 rel apart) distinct.
    """
    if x == 0.0 or not math.isfinite(x):
        return x
    return round(x, digits - 1 - math.floor(math.log10(abs(x))))


class Completion(NamedTuple):
    """One answered request (exact-shape, hardened, feasible by construction)."""

    req_id: int
    alloc: Allocation
    bucket: tuple       # (N_pad, K_pad)
    latency_s: float    # arrival -> answer (queue wait + batched solve)
    wait_s: float       # arrival -> flush
    solve_s: float      # the batched solve this request rode in
    #: eq. 13 objective of ``alloc``, scored on the padded bucket batch
    #: (== `system.objective` on the exact-shape scenario to float32
    #: round-off); None when ``ServeConfig.score_objective`` is off
    objective: float | None = None
    #: True when this request rode a warm-start candidate into its flush
    warm_hit: bool = False
    #: the exact-shape warm-start entry (or tuple of entries, top-k) that
    #: rode along (None for a cold request), so a virtual-clock replay can
    #: re-inject the same starts and stay exact
    warm_start: CacheEntry | tuple | None = None


def _cold_program(cfg: AllocatorConfig, mesh):
    """The cold solver of one cache key: `solve_batch` with per-row weights
    and accuracy fits, sharded over ``mesh`` unless it is None."""
    def run(pb, wb, accb):
        return solve_batch(pb, wb, cfg, accb, weights_batched=True, acc_batched=True, mesh=mesh)
    return run


def _refine_program(cfg: AllocatorConfig, mesh):
    """The warm-refine pass of one cache key: the cold result plus the
    flush's `ExtraStart` batch -> the per-scenario best (sharded like the
    cold solver)."""
    def run(pb, wb, accb, extra, base):
        with torch.no_grad():
            return refine_with_start(pb, wb, cfg, accb, extra, base, mesh=mesh)
    return run


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class AllocService:
    """Micro-batched allocation server (see module docstring)."""

    def __init__(
        self,
        cfg: ServeConfig = ServeConfig(),
        executables: dict[tuple, object] | None = None,
        device="cuda",
        mesh=None,
    ):
        """``executables`` optionally shares a solver cache built by another
        service (the dict is used and extended in place); entries are keyed
        by the allocator config and the mesh, so services with other configs
        or another sharding miss. ``mesh`` is the scenario mesh of a
        ``shard_batch`` service (default `scenario_mesh()`: every CUDA
        device); requests and answers stay on ``device``."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.cfg = cfg
        # with shard_batch, policy.max_batch is the per-device batch: buckets
        # fill (and pad) to len(mesh) x max_batch slots
        self.mesh = scenario_mesh(mesh) if cfg.shard_batch else None
        n_dev = len(self.mesh) if self.mesh is not None else 1
        self._full_slots = cfg.policy.max_batch * n_dev
        self.batcher = MicroBatcher(cfg.policy._replace(max_batch=self._full_slots))
        self.metrics = ServiceMetrics()
        self._executables = executables if executables is not None else {}
        #: all-tenants default A(rho); per-tenant overrides live in
        #: `_tenant_acc` and win for their own tenant's admissions
        self._acc = default_accuracy(dev)
        self._tenant_acc: dict = {}
        self._next_id = 0
        #: warm-start solution cache (None when disabled); thread-safe on its
        #: own lock: `prepare` reads it from caller threads, the solver
        #: thread writes it after each flush
        self.warm_cache = (
            WarmStartCache(cfg.warmstart) if cfg.warmstart is not None else None
        )

    @property
    def executables(self) -> dict[tuple, object]:
        """The solver cache, keyed by (bucket key, batch slots,
        AllocatorConfig, mesh), plus ("warm-refine", n_cand) for the refine
        pass; pass it to another AllocService to share its entries."""
        return self._executables

    # -- admission ----------------------------------------------------------

    def _pad(self, params: SystemParams) -> SystemParams:
        # canonicalise B at the service boundary, in both bucket modes, so
        # equal-bbar requests that reconstructed B through different float
        # round-trips land in one queue (`_round_sig`)
        if self.cfg.buckets is None:
            return dataclasses.replace(params, B=_round_sig(params.B))
        padded = pad_params(params, bucket_for(params.N, params.K, self.cfg.buckets))
        return dataclasses.replace(padded, B=_round_sig(padded.B))

    @staticmethod
    def _bucket_key(padded: SystemParams) -> tuple:
        # shape + every static meta field: one queue == one solver
        return (
            padded.N, padded.K, padded.B, padded.N0,
            padded.xi, padded.eta, padded.q,
        )

    def _on_device(self, tree):
        """A weights / accuracy tree with float32 leaves on the service's
        device (a caller may hand python floats or host scalars)."""
        return type(tree)(**{
            f.name: torch.as_tensor(getattr(tree, f.name), dtype=torch.float32).to(self.device)
            for f in dataclasses.fields(tree)
        })

    def _resolve_accuracy(self, accuracy=None, tenant=None) -> AccuracyFn:
        """The A(rho) fit a request is stamped with at admission: an explicit
        ``accuracy`` wins, else the ``tenant``'s registered fit, else the
        all-tenants default."""
        if accuracy is not None:
            return accuracy
        if tenant is not None and tenant in self._tenant_acc:
            return self._tenant_acc[tenant]
        return self._acc

    def prepare(
        self,
        params: SystemParams,
        weights: Weights | None = None,
        warm_start=None,
        accuracy: AccuracyFn | None = None,
        tenant=None,
    ) -> PendingRequest:
        """Pad/canonicalise one scenario into its bucket without touching any
        queue state (``req_id``/``arrival_t`` are placeholders until `admit`).

        The stateless half of admission: the real-clock driver runs it on
        the caller's thread. The request's A(rho) fit is resolved and stamped
        here, so a `set_accuracy` racing the queue never re-steers an
        admitted request. The warm-cache lookup happens here too, keyed on
        the request's own fit; an explicit ``warm_start`` entry (or tuple of
        entries) takes precedence over the cache."""
        if params.device != self.device:
            raise ValueError(
                f"request scenario is on {params.device}, the service on {self.device}"
            )
        w = self._on_device(weights if weights is not None else Weights.ones())
        acc = self._on_device(self._resolve_accuracy(accuracy, tenant))
        sig = None
        if self.warm_cache is not None:
            sig = request_signature(params, w, acc, self.cfg.warmstart)
        entry = warm_start
        # CacheEntry IS a tuple (NamedTuple): only normalise genuine
        # candidate lists, never a bare entry
        if isinstance(entry, (list, tuple)) and not isinstance(entry, CacheEntry):
            entry = tuple(entry) if entry else None
        if entry is None and self.warm_cache is not None:
            hits = self.warm_cache.lookup(sig, self.cfg.warmstart.top_k)
            entry = hits[0] if len(hits) == 1 else (tuple(hits) or None)
        return PendingRequest(
            req_id=-1,
            params=params,
            padded=self._pad(params),
            weights=w,
            arrival_t=0.0,
            accuracy=acc,
            warm_start=entry,
            warm_sig=sig,
        )

    def admit(self, req: PendingRequest, now: float) -> int:
        """Assign a request id and enqueue a `prepare`d request (arrival
        stamped at ``now``). Like every other state mutation of this sans-IO
        service, call it from a single thread (the driver's solver thread)."""
        req.req_id = self._next_id
        self._next_id += 1
        req.arrival_t = now
        self.batcher.add(self._bucket_key(req.padded), req)
        self.metrics.observe_submit(self.batcher.depth())
        return req.req_id

    def submit(
        self,
        params: SystemParams,
        weights: Weights | None = None,
        now: float = 0.0,
        warm_start=None,
        accuracy: AccuracyFn | None = None,
        tenant=None,
    ) -> int:
        """Admit one scenario; returns its request id. Does not solve: call
        `flush_full` / `flush_due` / `drain` to get completions."""
        return self.admit(
            self.prepare(params, weights, warm_start, accuracy, tenant), now
        )

    def set_buckets(self, buckets: tuple[ShapeBucket, ...] | None) -> None:
        """Swap the bucket ladder (e.g. a learned `serve.ladder` refit). Safe
        mid-stream: queued requests keep the bucket they were admitted into,
        only new admissions see the new ladder, and the solver cache adds
        entries for new buckets on first flush."""
        self.cfg = self.cfg._replace(buckets=buckets)

    def set_accuracy(self, acc, tenant=None) -> None:
        """Update the A(rho) model later admissions are stamped with: the
        all-tenants default, or with ``tenant`` that tenant's fit only. A
        refit changes no cache key; already-queued requests keep the fit they
        were admitted with, and warm-cache entries recorded under the old
        model stay valid (a hit is re-solved and re-scored under the
        rider's current fit)."""
        if tenant is None:
            self._acc = acc
        else:
            self._tenant_acc[tenant] = acc

    def pending(self) -> int:
        return self.batcher.depth()

    def next_deadline(self) -> float | None:
        return self.batcher.next_deadline()

    # -- the solver cache ------------------------------------------------------

    def _slots(self, n_real: int) -> int:
        """Batch-axis slots for a flush of ``n_real`` requests: fixed at
        ``len(mesh) x max_batch`` with ``pad_batch``, else the observed size
        (rounded up to the mesh size when sharding)."""
        if self.cfg.pad_batch:
            return self._full_slots
        if self.mesh is not None:
            return round_up(n_real, len(self.mesh))
        return n_real

    def _run(self, cache_key: tuple, make, *args):
        """Call the cached solver ``cache_key`` (made by ``make()`` on a miss)
        on ``args`` and synchronize; returns (result, seconds). A miss
        records that first call's time as the key's compile time."""
        hit = cache_key in self._executables
        if not hit:
            self._executables[cache_key] = make()
        program = self._executables[cache_key]
        t0 = time.perf_counter()
        out = program(*args)
        _synchronize(self.device)
        seconds = time.perf_counter() - t0
        self.metrics.observe_cache(hit=hit, compile_s=0.0 if hit else seconds)
        return out, seconds

    def _solve(self, key: tuple, slots: int, pb, wb, accb, extra):
        """The flush's solve: the cold solver, then (with any warm start)
        the refine pass for the flush's candidate count. Returns (result,
        solve seconds)."""
        cfg = self.cfg.allocator
        base = (key, slots, cfg, self.mesh)
        res, seconds = self._run(base, lambda: _cold_program(cfg, self.mesh), pb, wb, accb)
        if extra is not None:
            n_cand = 1 if np.ndim(extra.valid) == 1 else int(np.shape(extra.valid)[1])
            res, refine_s = self._run(
                base + ("warm-refine", n_cand), lambda: _refine_program(cfg, self.mesh),
                pb, wb, accb, extra, res,
            )
            seconds += refine_s
        return res, seconds

    def warmup(self, example_params) -> None:
        """Make and first-call the solvers of the buckets the example
        scenarios land in (so first requests don't pay the first call): the
        cold solver and, with warm starts on, the refine pass (and its
        top-k variant), on the examples replicated over the slots.

        With ``pad_batch=False`` only single-request flushes are prewarmed."""
        seen: dict[tuple, SystemParams] = {}
        for p in example_params:
            padded = self._pad(p)
            seen.setdefault(self._bucket_key(padded), padded)
        slots = self._slots(1)
        for key, padded in seen.items():
            pb = stack_params([padded] * slots)
            wb = stack_weights([self._on_device(Weights.ones())] * slots)
            accb = stack_accuracy([self._on_device(self._acc)] * slots)
            if self.cfg.warmstart is None:
                self._solve(key, slots, pb, wb, accb, None)
                continue
            # a placeholder entry fixes the shapes; its contents don't matter
            dummy = CacheEntry(
                f=0.5 * padded.f_max.cpu().numpy().astype(np.float32),
                P=np.zeros((padded.N, padded.K), dtype=np.float32),
                X=np.zeros((padded.N, padded.K), dtype=np.float32),
                objective=float("nan"),
            )
            self._solve(key, slots, pb, wb, accb,
                        batch_starts([dummy] + [None] * (slots - 1), [padded] * slots))
            top_k = self.cfg.warmstart.top_k
            if top_k > 1:
                extra_k = batch_starts([[dummy] * top_k] + [None] * (slots - 1),
                                       [padded] * slots, k=top_k)
                self._solve(key, slots, pb, wb, accb, extra_k)

    # -- flushing ------------------------------------------------------------

    def _flush_bucket(self, key: tuple, now: float) -> tuple[list[Completion], float]:
        pending = self.batcher.pop(key)
        n_real = len(pending)
        slots = self._slots(n_real)
        # pad the batch axis by replicating the last request: same shape ->
        # same solver; replicas are solved and discarded
        filled = pending + [pending[-1]] * (slots - n_real)
        pb = stack_params([r.padded for r in filled])
        wb = stack_weights([r.weights for r in filled])
        # each row rides its own A(rho) fit, stamped at `prepare`
        accb = stack_accuracy(
            [r.accuracy if r.accuracy is not None else self._acc for r in filled]
        )
        # one ExtraStart batch iff any rider has a warm start; a hitless
        # flush runs the cold solver only (cold == disabled, per flush)
        extra = batch_starts(
            [r.warm_start for r in filled],
            [r.padded for r in filled],
            k=self.cfg.warmstart.top_k if self.cfg.warmstart is not None else None,
        )
        res, solve_s = self._solve(key, slots, pb, wb, accb, extra)
        self.metrics.observe_batch(n_real, slots, solve_s)
        # score the padded batch in one call, outside solve_s, under the
        # per-row fits the rows were solved with
        objs = None
        if self.cfg.score_objective:
            use_kernel = "auto" if self.cfg.allocator.use_kernel_objective else False
            objs = batch_objectives(
                pb, wb, res.alloc, accb, weights_batched=True, use_kernel=use_kernel
            ).cpu().numpy()

        # convergence traces for the iteration-savings metric (one host copy
        # per flush, only when warm starts are in play on this service)
        traces = (
            res.trace.cpu().numpy()
            if (self.cfg.warmstart is not None or extra is not None)
            else None
        )
        iters_rtol = (self.cfg.warmstart or WarmStartConfig()).iters_rtol

        out = []
        for i, req in enumerate(pending):
            alloc = unpad_alloc(tree_index(res.alloc, i), req.params.N, req.params.K)
            obj = float(objs[i]) if objs is not None else None
            # record the hardened solution for later requests under this
            # signature (exact shape: one entry serves every covering bucket)
            if self.warm_cache is not None and req.warm_sig is not None:
                self.warm_cache.put(req.warm_sig, entry_from_alloc(alloc, obj))
            if traces is not None:
                self.metrics.observe_warm(
                    hit=req.warm_start is not None,
                    iters=iters_to_converge(traces[i], iters_rtol),
                )
            wait = now - req.arrival_t
            latency = wait + solve_s
            self.metrics.observe_completion(latency, wait)
            out.append(
                Completion(
                    req_id=req.req_id,
                    alloc=alloc,
                    bucket=(key[0], key[1]),
                    latency_s=latency,
                    wait_s=wait,
                    solve_s=solve_s,
                    objective=obj,
                    warm_hit=req.warm_start is not None,
                    warm_start=req.warm_start,
                )
            )
        return out, solve_s

    def _flush_while(self, select, now: float) -> tuple[list[Completion], float]:
        """Flush buckets returned by ``select()`` until none qualify; a queue
        deeper than ``max_batch`` flushes in successive batches."""
        completions: list[Completion] = []
        busy = 0.0
        while True:
            keys = select()
            if not keys:
                return completions, busy
            for key in keys:
                # single-server semantics: batches run back-to-back, so
                # requests in a later bucket also wait out earlier solves
                done, solve_s = self._flush_bucket(key, now + busy)
                completions.extend(done)
                busy += solve_s

    def flush_full(self, now: float) -> tuple[list[Completion], float]:
        """Flush buckets that reached ``max_batch``. Returns (completions,
        busy seconds spent solving)."""
        return self._flush_while(self.batcher.full_keys, now)

    def flush_due(self, now: float) -> tuple[list[Completion], float]:
        """Flush buckets that are full or whose oldest request waited out
        ``max_wait_s`` by ``now``."""
        return self._flush_while(lambda: self.batcher.due_keys(now), now)

    def drain(self, now: float) -> tuple[list[Completion], float]:
        """Flush everything (shutdown / end of a load run)."""
        return self._flush_while(self.batcher.keys, now)
