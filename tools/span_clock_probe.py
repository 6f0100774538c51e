#!/usr/bin/env python3
"""Measure how far the torch profiler places a kernel from two CUDA events
recorded around its launch on the same stream, on the host clock.

    python3 tools/span_clock_probe.py [--batch 48] [--calls 30] [--queue 2000]
                                      [--long-s 5] [--solves 3]

Under `fedbench.yardstick.trace.DeviceTrace` (CUDA activity only, as in a
traced benchmark run) it brackets each call of
`repro_torch.core.scoring.candidate_objectives`, which launches the
objective kernel once, between two timing events, in four profiles: on an
idle card (``--calls`` calls, a synchronize before each); behind a deep
queue (``--queue`` small kernels behind a spin of about 60 ms, queued
before the calls); spread over ``--long-s`` seconds of small kernels; and
in ``--solves`` smoke-depth `solve_batch` calls and their
`batch_objectives`, one profile each (about 128k kernels in 5 s). The
events are put on the host clock as `repro_torch.spans` puts a span's (an
anchor event read against `time.time_ns()`), and each objective-kernel
record is matched to its call's interval. Prints, per profile, how far
each record starts after the first event and ends before the second, in
ms; a negative value is a record outside its interval, where stream order
puts every record inside. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def probe(args, mode: str) -> list:
    """(start after the first event, end before the second) in ms, for each
    objective record of one profile."""
    import torch

    from fedbench.yardstick import trace
    from fedbench.yardstick.names import PORT_KERNELS
    from repro_torch.core import AllocatorConfig, Weights, allocator, batch_objectives, sample_params_batch, scoring
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.core.types import Allocation
    from repro_torch.spans import CudaClock

    params = sample_params_batch(3, args.batch, device="cuda")
    one = torch.tensor(1.0, device="cuda")
    w = Weights(one, one, one)
    f, P, X = allocator.equal_start(params)
    alloc = Allocation(f=f, P=P, X=X, rho=torch.full_like(f[..., 0], 0.5))
    filler = torch.zeros(16, device="cuda")
    solver = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=60))
    marks = []
    plain = scoring.candidate_objectives

    def bracketed(*a, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = plain(*a, **kw)
        e1.record()
        marks.append((e0, e1))
        return out

    def work():
        if mode == "solve":
            batch_objectives(params, w, allocator.solve_batch(params, w, solver).alloc)
            return
        if mode == "deep":
            torch.cuda._sleep(100_000_000)        # about 60 ms
            for _ in range(args.queue):
                filler.add_(1.0)
        t0 = time.perf_counter()
        for i in range(args.calls):
            if mode == "idle":
                torch.cuda.synchronize()
            while mode == "long" and time.perf_counter() < t0 + args.long_s * (i + 1) / args.calls:
                for _ in range(100):
                    filler.add_(1.0)
            batch_objectives(params, w, alloc)

    scoring.candidate_objectives = allocator.candidate_objectives = bracketed
    try:
        work()                                    # builds and warms every kernel
        marks.clear()
        tracer = trace.DeviceTrace()
        tracer.start()
        work()
        rows = tracer.stop()
    finally:
        scoring.candidate_objectives = allocator.candidate_objectives = plain
    clock = CudaClock()
    now, anchor = clock.anchor(torch.cuda.current_stream())
    placed = [[now - round(clock.elapsed_ns(e, anchor)) for e in pair] for pair in marks]
    records = [r for r in rows if PORT_KERNELS["objective"] in r[0]]
    if len(records) != len(placed):
        print(f"  {mode}: {len(records)} objective records for {len(placed)} calls", flush=True)
    return [((s - a) / 1e6, (b - e) / 1e6) for (_, s, e), (a, b) in zip(records, placed)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--queue", type=int, default=2000)
    ap.add_argument("--long-s", type=float, default=5.0)
    ap.add_argument("--solves", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for mode in ["idle", "deep", "long"] + ["solve"] * args.solves:
        got = probe(args, mode)
        show = [tuple(round(x, 3) for x in p) for p in (got if len(got) <= 5 else got[:2] + got[-2:])]
        least = min(min(p) for p in got) if got else float("nan")
        print(f"{mode}: records' start after the first event, end before the second (ms): "
              f"{show}; least {least:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
