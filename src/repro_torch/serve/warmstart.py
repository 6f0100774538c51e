"""Warm-start solution-reuse cache for recurring users.

Counterpart of `repro.serve.warmstart`. Signatures are computed from host
floats (the gains copied to numpy), so for the same numpy scenario the
port's signature tuple equals the reference's and a hit in one package is
a hit in the other.

At millions-of-users scale, serving requests are not i.i.d.: a device's
channel state is temporally correlated (the ``gauss_markov`` scenario family
is exactly that trace) and the same (N, K) populations recur, so the
allocator keeps re-deriving solutions it has already found. This module
keys a bounded, thread-safe cache on a *quantized signature* of the
request — canonical bucket meta, per-device mean channel gains, the A(rho)
accuracy fit and the objective weights — and feeds hits back into
`solve_batch` as one more multi-start candidate (`core.allocator.ExtraStart`).

Why coarse quantization is safe — the dominance invariant: the multi-start
machinery already selects the best candidate, so a cache hit can only help
or tie, never hurt (`refine_with_start`: a stale or outright wrong-scenario
entry is re-solved and re-scored under the CURRENT scenario and accuracy
model, and loses the argmin if it isn't better). That frees the signature to
be deliberately lossy — ~6 dB gain steps collide "similar enough" channels
onto one key, which is what produces hits on a correlated trace — because a
wrong collision costs one extra inner solve, not a wrong answer.

Equivalence rows this module adds (docs/ARCHITECTURE.md; re-proved for the
port in tests/test_torch_warmstart.py):

* **cold == disabled, exact X**: with the cache empty or ``warmstart=None``
  the service runs the unchanged cold solve only — bit-for-bit the same
  hardened assignment as without the cache.
* **warm never-worse objective**: with any cache state, every request's
  eq. 13 objective is <= its cold objective (tie allowed, float32
  round-off).

Storage is exact-shape: entries hold the hardened (f, P, X) at the
scenario's real (N, K) and are padded into whatever bucket the *next*
request lands in at attach time (`pad_start` is mask-aware, mirroring
`pad_params`), so one cached solution serves every covering bucket and
ladder refits never invalidate the cache.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import NamedTuple

import numpy as np

from ..core import SystemParams, Weights
from ..core.allocator import ExtraStart


def _np(x) -> np.ndarray:
    """A host numpy copy of a tensor (numpy arrays pass through)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class WarmStartConfig(NamedTuple):
    """Warm-start cache knobs (attach to `ServeConfig.warmstart`; None there
    disables the cache entirely — the cold path, bit-for-bit)."""

    #: max cached solutions; beyond it the least-recently-USED entry is
    #: evicted (a hit refreshes recency), bounding memory like the metrics
    #: reservoirs bound theirs
    capacity: int = 256
    #: per-device mean-gain quantization step [dB]: requests whose per-device
    #: mean channel gains agree within this step share a signature. Coarse on
    #: purpose — see the module docstring's dominance argument
    gain_quant_db: float = 6.0
    #: significant figures kept of the A(rho) fit (a, b) in the signature; a
    #: re-fit within round-off hits the same key (stale entries re-score
    #: under the NEW model — the set_accuracy regression test)
    acc_digits: int = 3
    #: significant figures kept of the objective weights (kappa1..3)
    weight_digits: int = 3
    #: relative tolerance declaring the objective trace "converged" for the
    #: solve-iteration-savings metric (`iters_to_converge`)
    iters_rtol: float = 1e-3
    #: warm-start candidates fed per request: 1 (default) attaches the exact
    #: signature hit only — the legacy single-candidate program, bit-for-bit.
    #: k > 1 additionally attaches up to k-1 nearest quantized-signature
    #: NEIGHBOURS (`WarmStartCache.lookup`: same signature except the gain
    #: steps, ranked by L1 gain-step distance) and the refine pass argmins
    #: over the whole candidate list — dominance still holds per candidate
    top_k: int = 1


class CacheEntry(NamedTuple):
    """One cached solution at its scenario's EXACT (N, K) shape (numpy, host
    memory — entries never pin device buffers)."""

    f: np.ndarray   # (N,)
    P: np.ndarray   # (N, K)
    X: np.ndarray   # (N, K) hardened {0,1}
    objective: float  # eq. 13 value when recorded (diagnostic ONLY — hits
    #                   are always re-scored under the current scenario and
    #                   accuracy model, never trusted from here)


def _quant_sig(x: float, digits: int) -> float:
    """Round to ``digits`` significant figures (signature canonicalisation,
    same scheme as the service's bucket-key `_round_sig` but coarser)."""
    x = float(x)
    if x == 0.0 or not math.isfinite(x):
        return x
    return round(x, digits - 1 - math.floor(math.log10(abs(x))))


def request_signature(
    params: SystemParams,
    weights: Weights,
    acc,
    cfg: WarmStartConfig = WarmStartConfig(),
) -> tuple:
    """Hashable, deliberately-lossy identity of a request for cache keying.

    Components: exact shape (N, K) and the canonical bucket meta (per-
    subcarrier bandwidth, noise PSD, xi, eta, q) — these must match exactly
    for an entry's arrays to even be shape-compatible — plus the lossy part:
    per-device MEAN channel gain quantized to ``gain_quant_db`` steps, and
    the accuracy fit / objective weights rounded to a few significant
    figures. Correlated channels (``gauss_markov``) drift slowly through the
    quantization cells, so consecutive requests from the same population
    collide on purpose; the dominance invariant makes any false collision
    harmless (module docstring).
    """
    g = _np(params.g).astype(np.float64)
    mask = _np(params.dev_mask).astype(np.float64)
    # per-device mean gain in dB, quantized; padded devices (mask 0) read 0
    mean_g = np.maximum(g.mean(axis=-1), 1e-30)
    steps = np.rint(10.0 * np.log10(mean_g) / cfg.gain_quant_db)
    gains = tuple(int(s) if m > 0 else 0 for s, m in zip(steps, mask))
    a = _quant_sig(getattr(acc, "a", 0.0), cfg.acc_digits)
    b = _quant_sig(getattr(acc, "b", 0.0), cfg.acc_digits)
    kappas = tuple(
        _quant_sig(k, cfg.weight_digits)
        for k in (weights.kappa1, weights.kappa2, weights.kappa3)
    )
    bbar = _quant_sig(params.B / params.K, 12)
    return (
        params.N, params.K, bbar, params.N0, params.xi, params.eta, params.q,
        gains, (a, b), kappas,
    )


class WarmStartCache:
    """Bounded, thread-safe LRU of `CacheEntry` keyed by `request_signature`.

    `get` runs on CALLER threads (the driver attaches hits during `prepare`,
    off the solver thread); `put` runs on the solver thread after each flush
    — hence the lock. Both are O(1) OrderedDict moves; entries are plain
    numpy, so neither path touches the device. Stats are monotonic counters
    snapshot by `stats()` (hits + misses == lookups, puts - evictions ==
    len).
    """

    def __init__(self, cfg: WarmStartConfig = WarmStartConfig()):
        if cfg.capacity < 1:
            raise ValueError(f"warm-start capacity must be >= 1, got {cfg.capacity}")
        self.cfg = cfg
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, sig: tuple) -> CacheEntry | None:
        with self._lock:
            entry = self._entries.get(sig)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(sig)   # refresh LRU recency
            self.hits += 1
            return entry

    def lookup(self, sig: tuple, k: int | None = None) -> list[CacheEntry]:
        """Up to ``k`` warm-start candidates for ``sig``, best first.

        ``k`` defaults to ``cfg.top_k``. With ``k == 1`` this is exactly
        `get` (exact-signature hit or nothing — the legacy path, same LRU
        refresh and hit/miss accounting). With ``k > 1`` the exact hit (if
        any) leads and the remainder are the nearest NEIGHBOURS: entries
        whose signature matches in every component except the quantized gain
        steps, ranked by L1 distance over those steps. Neighbour reads do
        not refresh recency (they are speculative candidates, not uses of
        their own key) and the call still counts one hit/miss: a lookup is a
        hit iff it returns any candidate.
        """
        if k is None:
            k = self.cfg.top_k
        if k <= 1:
            entry = self.get(sig)
            return [entry] if entry is not None else []
        with self._lock:
            out = []
            exact = self._entries.get(sig)
            if exact is not None:
                self._entries.move_to_end(sig)
                out.append(exact)
            ref_gains = sig[7]
            scored = []
            for other, entry in self._entries.items():
                if other == sig or other[:7] != sig[:7] or other[8:] != sig[8:]:
                    continue
                dist = sum(abs(a - b) for a, b in zip(ref_gains, other[7]))
                scored.append((dist, other, entry))
            scored.sort(key=lambda t: (t[0], t[1]))
            out.extend(e for _, _, e in scored[: k - len(out)])
            if out:
                self.hits += 1
            else:
                self.misses += 1
            return out

    def put(self, sig: tuple, entry: CacheEntry) -> None:
        with self._lock:
            self.puts += 1
            self._entries[sig] = entry
            self._entries.move_to_end(sig)
            while len(self._entries) > self.cfg.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "warm_cache_size": len(self._entries),
                "warm_cache_capacity": self.cfg.capacity,
                "warm_cache_hits": self.hits,
                "warm_cache_misses": self.misses,
                "warm_cache_puts": self.puts,
                "warm_cache_evictions": self.evictions,
                "warm_cache_hit_rate": self.hits / lookups if lookups else 0.0,
            }


def entry_from_alloc(alloc, objective: float | None = None) -> CacheEntry:
    """Freeze an exact-shape `Allocation` into a host-side `CacheEntry`."""
    return CacheEntry(
        f=_np(alloc.f).astype(np.float32),
        P=_np(alloc.P).astype(np.float32),
        X=_np(alloc.X).astype(np.float32),
        objective=float(objective) if objective is not None else float("nan"),
    )


def pad_start(entry: CacheEntry, padded: SystemParams) -> tuple:
    """Pad an exact-shape entry to a bucket's (N_pad, K_pad) — mask-aware,
    mirroring `pad_params`: the real block carries the cached solution, the
    padded tail gets the built-in starts' inert values (f = f_max/2, P = X =
    0), so a padded warm candidate solves exactly like its exact-shape twin
    (gated by the padded-vs-exact-hit test)."""
    n, k = entry.f.shape[0], entry.P.shape[1]
    f = 0.5 * _np(padded.f_max).astype(np.float32)
    f[:n] = entry.f
    P = np.zeros((padded.N, padded.K), dtype=np.float32)
    P[:n, :k] = entry.P
    X = np.zeros((padded.N, padded.K), dtype=np.float32)
    X[:n, :k] = entry.X
    return f, P, X


def batch_starts(
    entries: list, padded_list: list, k: int | None = None
) -> ExtraStart | None:
    """Stack per-slot cache hits into the `ExtraStart` batch `solve_batch`
    consumes; ``entries[i]`` is None (miss), one `CacheEntry`, or a
    list/tuple of candidates (`WarmStartCache.lookup` top-k). Misses get
    placeholder arrays with ``valid`` 0 — the refine pass returns that row's
    cold result bit-for-bit. Returns None when every slot missed, which
    tells the service to run the plain cold solve — the cold==disabled
    row.

    Shape discipline keeps the program count bounded: when every
    slot holds at most ONE candidate the legacy (B,)-valid layout is
    emitted (bit-compatible with the single-candidate refine program);
    otherwise candidates pad to a (B, C) axis with C = ``k`` when given
    (so every multi-candidate flush of a service shares one program) else
    the flush's max candidate count.
    """
    # NB: CacheEntry IS a tuple (NamedTuple) — test it first or a single
    # entry would explode into its four field arrays
    norm = [
        []
        if e is None
        else [e]
        if isinstance(e, CacheEntry)
        else list(e)
        if isinstance(e, (list, tuple))
        else [e]
        for e in entries
    ]
    c_max = max((len(c) for c in norm), default=0)
    if c_max == 0:
        return None
    if c_max <= 1:
        fs, Ps, Xs, valid = [], [], [], []
        for cands, padded in zip(norm, padded_list):
            if not cands:
                fs.append(0.5 * _np(padded.f_max).astype(np.float32))
                Ps.append(np.zeros((padded.N, padded.K), dtype=np.float32))
                Xs.append(np.zeros((padded.N, padded.K), dtype=np.float32))
                valid.append(0.0)
            else:
                f, P, X = pad_start(cands[0], padded)
                fs.append(f)
                Ps.append(P)
                Xs.append(X)
                valid.append(1.0)
        return ExtraStart(
            f=np.stack(fs),
            P=np.stack(Ps),
            X=np.stack(Xs),
            valid=np.asarray(valid, dtype=np.float32),
        )
    C = max(c_max, k or 0)
    fs, Ps, Xs, valid = [], [], [], []
    for cands, padded in zip(norm, padded_list):
        row_f, row_P, row_X, row_v = [], [], [], []
        for c in range(C):
            if c < len(cands):
                f, P, X = pad_start(cands[c], padded)
                v = 1.0
            else:
                f = 0.5 * _np(padded.f_max).astype(np.float32)
                P = np.zeros((padded.N, padded.K), dtype=np.float32)
                X = np.zeros((padded.N, padded.K), dtype=np.float32)
                v = 0.0
            row_f.append(f)
            row_P.append(P)
            row_X.append(X)
            row_v.append(v)
        fs.append(np.stack(row_f))
        Ps.append(np.stack(row_P))
        Xs.append(np.stack(row_X))
        valid.append(np.asarray(row_v, dtype=np.float32))
    return ExtraStart(
        f=np.stack(fs),
        P=np.stack(Ps),
        X=np.stack(Xs),
        valid=np.stack(valid),
    )


def iters_to_converge(trace, rtol: float = 1e-3) -> int:
    """Outer iterations Alg. A2 needed before its objective trace entered
    ``rtol`` of the final value (the solve-iteration-savings metric: a warm
    start that lands near the optimum converges in fewer outer iterations
    than a cold one, even though the solver always runs all of
    them). Returns the 1-based iteration count; non-finite traces count as
    the full length (never converged)."""
    t = _np(trace).astype(np.float64).ravel()
    if t.size == 0 or not np.isfinite(t[-1]):
        return int(t.size)
    tol = rtol * max(1.0, abs(float(t[-1])))
    within = np.abs(t - t[-1]) <= tol
    # first index from which the trace STAYS within tolerance
    stays = np.flip(np.logical_and.accumulate(np.flip(within)))
    first = int(np.argmax(stays)) if stays.any() else t.size - 1
    return first + 1
