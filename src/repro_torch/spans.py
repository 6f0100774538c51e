"""Spans and counters inside the program, kept in memory.

A span is one layer's share of one request: a name, an id, its parent's
id, the id of its request (the root span), a few attributes (rows, steps,
tokens, layer index and kind), its start and end on the host clock
(`time.time_ns()`, the clock the torch profiler stamps its device records
with) and, on a CUDA tensor's path, its interval on the device.

The store records only while a torch profiler session is active on the
calling thread, the rule `torch.profiler.record_function` follows: spans
come with a profile and cost one check each without one. A request is
opened with `root` (one `solve_batch`, one `prefill`, one
`batch_objectives`); a `span` or `count` outside an open request records
nothing, so a layer shared with paths that open no request (training,
decode, a solver called alone) stays silent there.

Device intervals come from `torch.cuda.Event(enable_timing=True)` records
on the request's stream (the current one at its entry). A span's entry
reuses its previous sibling's exit event, so adjacent spans share events
and work the host launches between two siblings counts to the later one;
a first child records its own entry, and every exit its own event.
Events are resolved when the spans are read (`snapshot`), after the
device's work: the store then records a few anchor events on the idle
device, reading the host clock around each, and keeps the one whose record
call returned soonest. An event's host time is the anchor's less its
`elapsed_time` to the anchor (the card's event clock and the host's drift
apart by a few parts per million).

Counters: `count(name, n)` adds to a named counter and to the attribute of
that name of the innermost open span. Each span also records how far the
kernel modules' own launch counters (`LAUNCH_COUNTERS`) moved while it was
open.

Readout: `snapshot()` returns the spans and counters; `clear()` empties the
store. The store holds at most `MAX_SPANS` spans and counts the ones it
drops. Only a thread with a profiler session records, so one thread at a
time writes to the store.
"""
from __future__ import annotations

import sys
import time

import torch

#: whether a torch profiler session is active on the calling thread
_profiling = torch._C._autograd._profiler_enabled

MAX_SPANS = 1 << 20

#: (attribute, module) of each kernel module whose ``launches`` a span
#: records the change of; a module not yet imported has launched nothing
LAUNCH_COUNTERS = (
    ("objective_launches", "repro_torch.kernels.fedsem_objective.kernel"),
    ("flash_launches", "repro_torch.kernels.flash_attention.kernel"),
    ("wkv6_launches", "repro_torch.kernels.rwkv6_scan.kernel"),
)


def _launches() -> list[int]:
    return [getattr(sys.modules.get(mod), "launches", 0) for _, mod in LAUNCH_COUNTERS]


class CudaClock:
    """Timing events on a CUDA stream and their host times."""

    #: anchors recorded at read time; the one whose record call returned
    #: soonest ties the card's clock to the host's best
    ANCHORS = 8

    @staticmethod
    def stream(device: torch.device):
        """The current stream of a CUDA device; None for another device."""
        return torch.cuda.current_stream(device) if device.type == "cuda" else None

    @staticmethod
    def record(stream):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def anchor(self, stream) -> tuple:
        """(host ns, event) of an event recorded on the idle stream."""
        stream.synchronize()
        best = None
        for _ in range(self.ANCHORS):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.time_ns()
            ev.record(stream)
            t1 = time.time_ns()
            ev.synchronize()
            if best is None or t1 - t0 < best[0]:
                best = (t1 - t0, (t0 + t1) // 2, ev)
        return best[1], best[2]

    @staticmethod
    def elapsed_ns(a, b) -> float:
        return a.elapsed_time(b) * 1e6


class _Span:
    __slots__ = ("store", "id", "parent", "root", "name", "attrs", "stream",
                 "t0", "t1", "e0", "e1", "d0", "d1", "l0", "l1")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.store.close(self)
        return False

    def as_dict(self) -> dict:
        attrs = dict(self.attrs)
        if self.l1 is not None:
            attrs.update((key, b - a) for (key, _), a, b in zip(LAUNCH_COUNTERS, self.l0, self.l1))
        return {"id": self.id, "parent": self.parent, "root": self.root, "name": self.name,
                "attrs": attrs, "host": (self.t0, self.t1),
                "device": (self.d0, self.d1) if self.d0 is not None else None}


class _Null:
    """The span of a call that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class Store:
    """The spans and counters of one process (module functions below act on
    `STORE`; a test may make its own with another clock)."""

    def __init__(self, cap: int = MAX_SPANS, clock=None):
        self.cap = cap
        self.clock = clock if clock is not None else CudaClock()
        self.clear()

    def clear(self) -> None:
        self.spans: list[_Span] = []
        self.stack: list[_Span] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0
        self._last = None      # (parent, its last child's exit event)

    def open(self, name: str, device, attrs: dict, root: bool):
        """Enter a span: a request's root (``root``), else a layer of the
        open request; NULL outside a request or past the cap."""
        stack = self.stack
        if not stack and not root:
            return NULL
        if len(self.spans) >= self.cap:
            self.dropped += 1
            return NULL
        s = _Span()
        s.store, s.name, s.attrs = self, name, attrs
        s.id = len(self.spans) + self.dropped
        s.t1 = s.e0 = s.e1 = s.d0 = s.d1 = s.l1 = None
        parent = stack[-1] if stack else None
        s.parent = parent.id if parent is not None else None
        s.root = parent.root if parent is not None else s.id
        if root:
            device = getattr(device, "device", device)
            s.stream = None if device is None else self.clock.stream(device)
        else:
            s.stream = parent.stream
        self.spans.append(s)
        stack.append(s)
        s.l0 = _launches()
        if s.stream is not None:
            last = self._last
            if not root and last is not None and last[0] is parent:
                s.e0 = last[1]
            else:
                s.e0 = self.clock.record(s.stream)
        s.t0 = time.time_ns()
        return s

    def close(self, s: _Span) -> None:
        stack = self.stack
        if not stack or stack[-1] is not s:         # the store was cleared meanwhile
            return
        s.t1 = time.time_ns()
        s.l1 = _launches()
        stack.pop()
        if s.stream is not None:
            s.e1 = self.clock.record(s.stream)
            self._last = (stack[-1], s.e1) if stack else None

    def count(self, name: str, n: int) -> None:
        if not self.stack:
            return
        self.counters[name] = self.counters.get(name, 0) + n
        attrs = self.stack[-1].attrs
        attrs[name] = attrs.get(name, 0) + n

    def resolve(self) -> None:
        """Put every closed span's events on the host clock (one anchor a
        stream) and let go of them."""
        by_stream: dict = {}
        for s in self.spans:
            if s.e1 is not None:
                by_stream.setdefault(s.stream, []).append(s)
        for stream, group in by_stream.items():
            now, anchor = self.clock.anchor(stream)
            for s in group:
                s.d0 = now - round(self.clock.elapsed_ns(s.e0, anchor))
                s.d1 = now - round(self.clock.elapsed_ns(s.e1, anchor))
                s.e0 = s.e1 = None
        self._last = None

    def snapshot(self) -> dict:
        self.resolve()
        return {"spans": [s.as_dict() for s in self.spans], "counters": dict(self.counters),
                "dropped": self.dropped}


STORE = Store()


def root(name: str, device=None, **attrs):
    """A request's root span (``device``: a tensor or device whose CUDA
    stream the request's spans time; None or a CPU one: host times only)."""
    if not _profiling():
        return NULL
    return STORE.open(name, device, attrs, True)


def span(name: str, **attrs):
    """A layer's span inside the open request, timed like its root."""
    if not _profiling():
        return NULL
    return STORE.open(name, None, attrs, False)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` and to the innermost open span's
    attribute of that name."""
    if _profiling():
        STORE.count(name, n)


def snapshot() -> dict:
    """{"spans": [{"id", "parent", "root", "name", "attrs", "host": (start
    ns, end ns), "device": (start ns, end ns) or None}, ...] in order of
    entry, "counters": {name: n}, "dropped": spans not kept}; the device
    intervals on the host clock. Call after the device work is done."""
    return STORE.snapshot()


def clear() -> None:
    """Empty the store."""
    STORE.clear()
