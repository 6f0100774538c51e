"""Serving demo: stream mixed-size scenarios through the micro-batched
allocation service and print each hardened answer and the service's
metrics.

Counterpart of the reference's ``examples/serve_scenarios.py``, plus
``--device`` (the card unless ``--device cpu``). The reference warms every
bucket's solver up before the traffic so that JAX compiles ahead of it;
the port compiles nothing per bucket, so the first flush of a bucket only
fills the solver cache (the "first calls" below). The stream is the port's
draw, so the numbers are not the reference's.

  PYTHONPATH=src python -m repro_torch.launch.serve_scenarios [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

from ..core import AllocatorConfig, Weights, bucket_for, sample_request_stream
from ..core.pgd import PGDConfig
from ..core.system import feasible, report
from ..fl import fold_seed
from ..paper.common import ready
from ..serve import AllocService, BatchPolicy, ServeConfig, poisson_arrivals, run_load

#: the example's allocator: the serving config at 3 outer iterations of 200 PGD steps
ALLOCATOR = AllocatorConfig(inner="pgd", outer_iters=3, pgd=PGDConfig(steps=200))


def run(device="cuda", allocator: AllocatorConfig | None = None):
    """(requests, `LoadResult`): 8 requests of sizes (3, 8), (4, 8), (4, 12)
    (one per-subcarrier bandwidth, so they pad into shared buckets) at 100
    req/s through a service of max_batch 4, max_wait 20 ms."""
    dev = ready(device)
    requests = sample_request_stream(0, 8, sizes=((3, 8), (4, 8), (4, 12)), device=dev)
    arrivals = poisson_arrivals(fold_seed(0, 1), len(requests), rate_hz=100.0)
    service = AllocService(
        ServeConfig(policy=BatchPolicy(max_batch=4, max_wait_s=0.02),
                    allocator=allocator or ALLOCATOR),
        device=dev,
    )
    return requests, run_load(service, requests, arrivals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    requests, result = run(args.device)

    print(f"{'req':>3s} {'(N,K)':>8s} {'bucket':>8s} {'latency':>9s} "
          f"{'objective':>10s} {'rho':>5s} feasible")
    w = Weights.ones(requests[0].device)
    for c in sorted(result.completions, key=lambda c: c.req_id):
        p = requests[c.req_id]
        r = report(p, w, c.alloc)
        print(f"{c.req_id:3d} {f'({p.N},{p.K})':>8s} "
              f"{f'({c.bucket[0]},{c.bucket[1]})':>8s} {c.latency_s*1e3:7.1f}ms "
              f"{float(r['objective']):10.3f} {float(r['rho']):5.2f} "
              f"{bool(feasible(p, c.alloc))}")

    s = result.summary
    print(f"\n{len(result.completions)} requests in {result.makespan_s*1e3:.0f}ms virtual "
          f"-> {result.throughput_rps:.1f} req/s | p50 {s['latency_p50_s']*1e3:.1f}ms "
          f"p95 {s['latency_p95_s']*1e3:.1f}ms | occupancy {s['batch_occupancy_mean']:.2f} "
          f"| {s['cache_misses']} first calls, {s['cache_hits']} cache hits")
    print("buckets used:", sorted({bucket_for(p.N, p.K) for p in requests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
