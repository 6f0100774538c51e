"""Scenario-allocation serving driver: Poisson load over `AllocService`.

Counterpart of `repro.launch.serve_alloc`, with the same flags plus
``--device`` (the card unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.serve_alloc --requests 32 --rate 20
  PYTHONPATH=src python -m repro_torch.launch.serve_alloc --driver real --ladder learned --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_alloc --driver real --scenario gauss_markov --ladder auto --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve_alloc --driver real --scenario gauss_markov --warmstart --smoke --device cpu

Generates a mixed-size scenario stream (shared per-subcarrier bandwidth so
sizes co-batch in one `ShapeBucket`) from any registered scenario family
(``--scenario``; ``gauss_markov`` gives time-correlated fading instead of
i.i.d. redraws per request), warms the compiled-solver cache, and drives the
micro-batched service two ways:

  * ``--driver virtual`` (default) — the reproducible discrete-event
    simulation: Poisson arrivals on a virtual clock, solves charged at
    measured wall time (`serve.loadgen`).
  * ``--driver real``    — the threaded real-clock front-end
    (`serve.driver.RealClockDriver`): this process paces arrivals with
    real sleeps and submits from the main thread while the solver thread
    overlaps flushes; shutdown drains every queue. With ``--smoke`` the same
    stream is then replayed through the virtual-clock loadgen and the
    hardened assignments must match request-for-request (exit 1 otherwise) —
    the CI gate on the driver's equivalence contract.

``--ladder learned`` fits an autoscaling bucket ladder to the stream's
observed (N, K) mix (`serve.ladder`) instead of `DEFAULT_BUCKETS` and
prints the predicted padded-area waste of both. ``--ladder auto`` (real
driver only) starts from `DEFAULT_BUCKETS` and lets the driver's solver
thread refit online when the observed mix's padded waste drifts past
`DriverConfig.refit_waste_threshold` — no pre-fit pass over the stream.
``--policy exact --max-batch 1`` degenerates to the solve-per-request
baseline the serving benchmark compares against.

``--warmstart`` enables the warm-start solution-reuse cache
(`serve.warmstart`): each completed request's hardened solution is
recorded under a quantized channel/accuracy signature, and later requests
with a colliding signature ride it as an extra multi-start candidate —
never-worse objectives (dominance), with cache hit/miss accounting in the
summary. Under ``--driver real --smoke`` the equivalence replay re-injects
the recorded per-request starts, so the exact-X gate covers warm runs too.

``--shard`` shards each flush over a scenario mesh (`core.distribute`):
every CUDA device, or with ``--device cpu`` the one CPU device; each bucket
then fills ``device count x --max-batch`` slots.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..core import DEFAULT_BUCKETS, AllocatorConfig
from ..core.pgd import PGDConfig
from ..core.system import feasible
from ..scenarios import list_families
from ..serve import (
    AllocService,
    BatchPolicy,
    DriverConfig,
    LadderLearner,
    RealClockDriver,
    ServeConfig,
    WarmStartConfig,
    pace_stream,
    poisson_arrivals,
    run_load,
    same_hardened_assignments,
    scenario_stream,
)


def build_config(args, buckets) -> ServeConfig:
    if args.smoke:
        allocator = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=60))
    else:
        allocator = AllocatorConfig(inner=args.inner)
    return ServeConfig(
        policy=BatchPolicy(max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3),
        buckets=buckets,
        allocator=allocator,
        shard_batch=args.shard,
        warmstart=WarmStartConfig() if args.warmstart else None,
    )


def fit_ladder(args, requests):
    """Resolve the bucket ladder for this run (None = exact shapes)."""
    if args.policy == "exact":
        if args.ladder != "fixed":
            print(f"--policy exact serves exact shapes; --ladder {args.ladder} ignored")
        return None
    if args.ladder in ("fixed", "auto"):
        # auto starts from the defaults; the driver refits online on drift
        return DEFAULT_BUCKETS
    learner = LadderLearner(min_samples=1)
    for p in requests:
        learner.observe(p.N, p.K)
    snap = learner.refit()
    print(
        f"learned ladder from {snap.n_observed} shapes: "
        f"{[(b.N, b.K) for b in snap.buckets]}\n"
        f"predicted padded-area waste: learned {snap.waste:.3f} "
        f"vs DEFAULT_BUCKETS {snap.baseline_waste:.3f}"
    )
    return snap.buckets


def drive_real(service, requests, arrivals, args) -> tuple[list, float]:
    """Pace the stream on the real clock through a `RealClockDriver`.

    ``--ladder auto`` attaches a `LadderLearner` plus the auto-refit
    thresholds, so the solver thread re-learns the bucket ladder mid-stream
    when the observed shape mix drifts. Otherwise no learner is attached:
    when ``--ladder learned`` the ladder was already fit on this same
    stream's shapes, and the driver observing them again would double-weight
    the prefix in any later refit."""
    if args.ladder == "auto" and args.policy != "exact":
        check = 4 if args.smoke else 64
        driver = RealClockDriver(
            service,
            cfg=DriverConfig(
                refit_waste_threshold=0.15,
                refit_check_every=check,
                refit_min_samples=check,
            ),
            ladder=LadderLearner(min_samples=1),
        )
    else:
        driver = RealClockDriver(service)
    futures, t_start = pace_stream(driver, requests, arrivals)
    driver.close(timeout=300.0)
    makespan = driver.now() - t_start
    completions = [f.result(timeout=0.0) for f in futures]  # resolved by drain
    if driver.ladder is not None:
        print(
            f"auto-refits: {driver.auto_refits}; serving ladder now "
            f"{[(b.N, b.K) for b in service.cfg.buckets]}"
        )
    return completions, makespan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=20.0, help="arrival rate [req/s]")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--policy", choices=("ladder", "exact"), default="ladder")
    ap.add_argument(
        "--driver",
        choices=("virtual", "real"),
        default="virtual",
        help="virtual: reproducible DES clock; real: threaded real-clock "
        "driver with paced arrivals (and, under --smoke, a virtual-clock "
        "equivalence replay that gates the exit status)",
    )
    ap.add_argument(
        "--ladder",
        choices=("fixed", "learned", "auto"),
        default="fixed",
        help="fixed: DEFAULT_BUCKETS; learned: fit the bucket ladder to the "
        "stream's observed (N, K) mix before serving; auto: start fixed and "
        "let the real-clock driver refit online on shape-mix drift "
        "(--driver real only)",
    )
    ap.add_argument(
        "--scenario",
        choices=list_families(),
        default="iid_rayleigh",
        help="registered scenario family the request stream is drawn from "
        "(gauss_markov: time-correlated fading across requests)",
    )
    ap.add_argument("--inner", choices=("pgd", "sca", "auto"), default="pgd")
    ap.add_argument(
        "--warmstart",
        action="store_true",
        help="enable the warm-start solution-reuse cache "
        "(serve.warmstart): completed hardened solutions re-enter "
        "later solves as an extra multi-start candidate — never-worse "
        "objectives by the dominance invariant, best paired with "
        "--scenario gauss_markov (time-correlated channels produce hits)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="tiny allocator + stream")
    ap.add_argument(
        "--shard",
        action="store_true",
        help="shard each flush over a scenario mesh of every CUDA device "
        "(the CPU alone with --device cpu); slots = devices x --max-batch",
    )
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.ladder == "auto" and args.driver != "real":
        ap.error("--ladder auto needs --driver real (online refit lives in "
                 "the real-clock driver's solver thread)")

    sizes = ((3, 8), (4, 8)) if args.smoke else ((3, 8), (4, 12), (6, 16))
    n = min(args.requests, 8) if args.smoke else args.requests
    requests = scenario_stream(
        args.seed, n, scenario=args.scenario, sizes=sizes, device=args.device
    )
    # arrivals from their own generator (the reference folds 1 into its key)
    arrivals = poisson_arrivals(args.seed + 1, n, args.rate)

    buckets = fit_ladder(args, requests)
    cfg = build_config(args, buckets)
    # the scenario mesh of --shard: every CUDA card, or the CPU alone
    mesh = None if torch.device(args.device).type == "cuda" else [args.device]
    service = AllocService(cfg, device=args.device, mesh=mesh)
    print(f"warming the solver cache for {len(set(sizes))} shapes ...")
    service.warmup(requests)

    if args.driver == "real":
        completions, makespan = drive_real(service, requests, arrivals, args)
        summary = service.metrics.summary()
        busy = service.metrics.solves_s.total     # exact even past the cap
    else:
        result = run_load(service, requests, arrivals)
        completions, makespan, busy = result.completions, result.makespan_s, result.busy_s
        summary = result.summary

    n_feas = sum(
        bool(feasible(requests[c.req_id], c.alloc)) for c in completions
    )
    if service.warm_cache is not None:
        summary = {**summary, **service.warm_cache.stats()}
    print(json.dumps(summary, indent=2))
    print(
        f"served {len(completions)}/{n} requests "
        f"({n_feas} feasible) in {makespan:.3f}s {args.driver} "
        f"({busy:.3f}s solving) -> {len(completions) / max(makespan, 1e-9):.1f} req/s"
    )
    ok = len(completions) == n and n_feas == n

    if args.driver == "real" and args.smoke:
        # equivalence gate: replay the same stream on the virtual clock (same
        # config, shared executable cache) — the hardened assignment of every
        # request must match the real-clock driver's answer exactly. With
        # --warmstart, cache contents are timing-dependent (batch boundaries
        # move which entries exist at each lookup), so the replay re-injects
        # the RECORDED per-request warm starts into a cache-disabled service
        # — same inputs, so still exact X equality
        replay_cfg = cfg._replace(warmstart=None)
        starts = None
        if args.warmstart:
            by_id = {c.req_id: c for c in completions}
            starts = [by_id[i].warm_start for i in range(len(requests))]
        replay = run_load(
            AllocService(replay_cfg, executables=service.executables, device=args.device,
                         mesh=mesh),
            requests,
            arrivals,
            warm_starts=starts,
        )
        same = same_hardened_assignments(completions, replay.completions)
        print(
            f"real-vs-virtual equivalence (exact hardened X, "
            f"{len(completions)} reqs): {same}"
        )
        ok = ok and same

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
