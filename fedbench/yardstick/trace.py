"""The device trace: `torch.profiler`'s CUPTI records of the card's kernels,
read without the profiler's per-event Python objects, and reduced to what
the per-layer metrics read.

`PROFILE_LEAD_IN`, `LEAD_IN_SYMBOL` and the lead-in itself are frozen from
chip_smoke.py:425-426 and :617 (`device_profile`): the profiler drops a
profile's leading device records, more of them the longer the process has
profiled, and none behind 3000 one-cycle sleeps, which the summary leaves
out. Only the device's activity is recorded (no host trace): a solve
launches about 1.8 M kernels, and recording the host's operations beside
them would cost more than the solve.
"""
from __future__ import annotations

import bisect
import time

PROFILE_LEAD_IN = 3000
LEAD_IN_SYMBOL = "spin_kernel"
#: how many entries the result line's breakdown lists
TOP = 10
#: longest kernel name kept in the breakdown
NAME_CHARS = 160


class DeviceTrace:
    """Records the card's kernels between `start` and `stop` (CUDA activity
    only), behind the lead-in of one-cycle sleeps."""

    def __init__(self):
        self.events = None

    def start(self):
        import torch
        from torch.autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import (
            ProfilerActivity, ProfilerConfig, ProfilerState, _ExperimentalConfig,
        )

        self._activities = {ProfilerActivity.CUDA}
        self._config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                      _ExperimentalConfig())
        torch.cuda.synchronize()
        _prepare_profiler(self._config, self._activities)
        _enable_profiler(self._config, self._activities)
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    def stop(self) -> list:
        """End the recording; the device's kernels as (name, start ns, end
        ns), in start order, the lead-in left out."""
        import torch
        from torch.autograd import DeviceType, _disable_profiler

        torch.cuda.synchronize()
        result = _disable_profiler()
        rows = []
        for e in result.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            if LEAD_IN_SYMBOL in name:
                continue
            start = e.start_ns()
            rows.append((name, start, start + e.duration_ns()))
        rows.sort(key=lambda r: r[1])
        self.events = rows
        return rows


def summarize(events, window_ns: tuple[int, int], spans=()) -> dict:
    """What the readers read from a trace over ``window_ns`` (host
    `time.time_ns()` at the window's start and end, the clock the profiler
    stamps its records with):

    * ``kernels``: {name: [launches, device seconds]} of the records that
      start inside the window;
    * ``busy_s``: the union of their intervals, clipped to the window;
    * ``window_s``: the window's length;
    * ``idle``: {label: seconds} of the device's idle time inside the window,
      each gap filed under the host span (start ns, end ns, label) that holds
      its midpoint, else "between the harness's spans".
    """
    lo, hi = window_ns
    kernels: dict[str, list] = {}
    busy = 0
    gaps = []
    cursor = lo
    for name, s, e in events:
        if s < lo or s >= hi:
            continue
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e9
        e = min(e, hi)
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = spans[i][2] if i >= 0 and spans[i][1] >= mid else "between the harness's spans"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return {"kernels": kernels, "busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "idle": idle}


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the device's idle time by what the host was doing."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: kv[1][1], reverse=True)[:TOP]
    idle = sorted(summary["idle"].items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return {"device_ops": [[name[:NAME_CHARS], secs] for name, (_, secs) in ops],
            "idle_gaps": [[label, secs] for label, secs in idle]}


def now_ns() -> int:
    """The host clock the profiler stamps its records with."""
    return time.time_ns()
