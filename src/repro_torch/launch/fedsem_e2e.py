"""The closed FedSem loop, end to end: FL-trained SemCom jobs served by the
live allocation stack.

Counterpart of `repro.launch.fedsem_e2e`, with the same phases and gates
plus ``--device`` (the card unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.fedsem_e2e --smoke
  PYTHONPATH=src python -m repro_torch.launch.fedsem_e2e --jobs 3 --rounds 6
  PYTHONPATH=src python -m repro_torch.launch.fedsem_e2e --smoke --device cpu

Four phases, one shared solver cache:

1. **Backend equivalence** (gates the exit): for the same round scenarios
   and `AllocatorConfig`, the `ServiceBackend` over a virtual-clock
   `AllocService` (each round padded into its bucket and slots) must return
   exactly the hardened X of the offline `PlannedBackend` (the rounds as one
   unpadded batch), round for round, and rho within 1e-6.
2. **Feedback loop** (gates the exit): one `SemComJob` trains the
   autoencoder over the virtual-clock service; its measurements must give
   an applied A(rho) refit whose curve is monotone nondecreasing on a rho
   grid.
3. **Multi-job serving** (gates completeness): J heterogeneous FL jobs
   (scenario families, sizes, seeds), each in its own thread and under its
   own tenant id, share one `RealClockDriver`; their rounds co-batch in the
   service. Each job's trajectory and the service's p95 latency and
   occupancy are reported.
4. **Non-interference** (gates the exit): each phase-3 job is re-run alone
   (same seed and tenant, a fresh virtual-clock service), and its whole
   trajectory (per-round loss, rho, energy, t_fl, objective, and every
   proxy-accuracy measurement) must equal its co-tenanted run exactly.

Phase 1 runs without feedback (a refit mid-run would make planned and
served answers differ by design), at the backend level, below `run_fl`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import AllocatorConfig, Weights, tree_bits
from ..core.pgd import PGDConfig
from ..device import resolve_device
from ..fl import (
    FLConfig,
    PlannedBackend,
    SemComJob,
    SemComJobConfig,
    SemComJobResult,
    ServiceBackend,
    fold_seed,
    sample_round_scenarios,
    serve_config_for,
)
from ..scenarios import generator
from ..semcom import AEConfig, init_params
from ..serve import AllocService, BatchPolicy, RealClockDriver, ServeConfig

#: (name, scenario family, n_clients, n_subcarriers) per concurrent job:
#: heterogeneous populations, channels and shapes, one allocation service
JOB_SPECS = (
    ("hetero", "hetero_classes", 4, 12),
    ("markov", "gauss_markov", 4, 12),
    ("iid", "iid_rayleigh", 6, 16),
)
JOB_SPECS_SMOKE = (
    ("hetero", "hetero_classes", 3, 8),
    ("markov", "gauss_markov", 4, 8),
)
#: the smoke allocator (`serve_alloc --smoke`'s)
SMOKE_ALLOCATOR = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=60))


def harness_config(smoke: bool, rounds: int | None = None, jobs: int | None = None):
    """Allocator, serve config, job specs, rounds, AE config, batch and eval
    batch; ``smoke`` shrinks everything to test scale (the smoke allocator)."""
    if smoke:
        allocator = SMOKE_ALLOCATOR
        specs = JOB_SPECS_SMOKE
        rounds = 3 if rounds is None else rounds
        ae = AEConfig(image_size=16, hidden=4, base_latent=4)
        batch, eval_batch = 4, 8
    else:
        allocator = AllocatorConfig(inner="pgd")
        specs = JOB_SPECS
        rounds = 6 if rounds is None else rounds
        ae = AEConfig(image_size=32, hidden=8, base_latent=8)
        batch, eval_batch = 8, 16
    if jobs is not None:
        specs = tuple(specs[i % len(specs)] for i in range(jobs))
    serve_cfg = serve_config_for(allocator, policy=BatchPolicy(max_batch=4, max_wait_s=0.02))
    return allocator, serve_cfg, specs, rounds, ae, batch, eval_batch


def make_job(spec, rounds: int, ae: AEConfig, batch: int, eval_batch: int,
             feedback: bool = True, device="cuda") -> SemComJob:
    name, family, n, k = spec
    return SemComJob(
        SemComJobConfig(
            fl=FLConfig(n_clients=n, n_subcarriers=k, rounds=rounds, local_steps=2,
                        scenario=family),
            ae=ae,
            batch_size=batch,
            eval_batch=eval_batch,
            feedback=feedback,
            name=name,
        ),
        device=device,
    )


def upload_bits(job: SemComJob) -> float:
    """The job's D_n: its codec's parameter bits (shapes only)."""
    return tree_bits(init_params(generator(0, job.device), job.ae))


def check_backend_equivalence(
    seed: int, fl_cfg: FLConfig, allocator: AllocatorConfig, serve_cfg: ServeConfig,
    d_bits: float, executables: dict, device="cuda",
) -> dict:
    """Phase 1: PlannedBackend vs the virtual-clock ServiceBackend on the
    same round scenarios: hardened X exactly, rho within 1e-6."""
    w = Weights.ones(device)
    scenarios = sample_round_scenarios(seed, fl_cfg, d_bits, device)
    planned = PlannedBackend(allocator)
    planned.open(scenarios, w)
    served = ServiceBackend(AllocService(serve_cfg, executables=executables, device=device))
    served.open(scenarios, w)
    x_equal, rho_close, rhos = True, True, []
    for rnd in range(fl_cfg.rounds):
        a, b = planned.allocate(rnd), served.allocate(rnd)
        x_equal &= bool(torch.equal(a.X, b.X))
        rho_close &= bool(np.allclose(float(a.rho), float(b.rho), atol=1e-6))
        rhos.append(float(a.rho))
    return {
        "rounds": fl_cfg.rounds,
        "rho_planned": rhos,
        "hardened_x_equal": x_equal,
        "rho_allclose": rho_close,
        "equivalent": x_equal and rho_close,
    }


def run_refit_loop(
    seed: int, job: SemComJob, serve_cfg: ServeConfig, executables: dict,
) -> tuple[SemComJobResult, dict]:
    """Phase 2: one SemComJob over the virtual-clock service, feedback on.
    Gate: a refit was applied and its A(rho) is monotone on a rho grid."""
    backend = ServiceBackend(AllocService(serve_cfg, executables=executables, device=job.device))
    result = job.run(seed, backend)
    fit = result.accuracy_fit
    grid = torch.linspace(0.05, 1.0, 20)
    vals = fit.value(grid).cpu().numpy() if fit is not None else np.zeros(1)
    monotone = bool(np.all(np.diff(vals) >= -1e-7))
    return result, {
        "refit_applied": result.refit_applied,
        "refit_round": result.refit_round,
        "fit_a": float(fit.a) if fit is not None else None,
        "fit_b": float(fit.b) if fit is not None else None,
        "fit_monotone": monotone,
        "n_measurements": len(result.measurements),
        "ok": bool(result.refit_applied and monotone),
    }


def tenant_id(job: SemComJob, i: int) -> str:
    """One tenant id per concurrent job slot (names repeat when ``--jobs``
    cycles the spec table, so the slot index tells them apart)."""
    return f"{job.cfg.name}:{i}"


def run_multijob(
    seed: int, jobs: list[SemComJob], serve_cfg: ServeConfig, executables: dict,
) -> tuple[list[SemComJobResult], dict]:
    """Phase 3: every job in its own thread, one shared `RealClockDriver`,
    each under its own tenant id. The service first calls the solvers of
    each job's round-0 bucket, so no first call lands mid-serve."""
    device = jobs[0].device
    warm = [
        sample_round_scenarios(fold_seed(seed, i), job.cfg.fl, upload_bits(job), device)[0]
        for i, job in enumerate(jobs)
    ]
    service = AllocService(serve_cfg, executables=executables, device=device)
    service.warmup(warm)
    with RealClockDriver(service) as driver:
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futs = [
                pool.submit(job.run, fold_seed(seed, i),
                            ServiceBackend(driver, tenant=tenant_id(job, i)))
                for i, job in enumerate(jobs)
            ]
            results = [f.result() for f in futs]
        driver.close(timeout=600.0)
        summary = driver.summary()
    return results, summary


def check_noninterference(
    seed: int, jobs: list[SemComJob], co_results: list[SemComJobResult],
    serve_cfg: ServeConfig, executables: dict,
) -> dict:
    """Phase 4: re-run each phase-3 job alone (same seed and tenant, a fresh
    virtual-clock service); its trajectory must equal the co-tenanted run's
    exactly. A request solves and scores under the fit stamped at its own
    admission, and co-batched rows are independent, so sharing a driver
    changes scheduling only. ``seed`` is phase 3's."""
    per_job = []
    for i, (job, co) in enumerate(zip(jobs, co_results)):
        backend = ServiceBackend(
            AllocService(serve_cfg, executables=executables, device=job.device),
            tenant=tenant_id(job, i),
        )
        solo = job.run(fold_seed(seed, i), backend)
        rounds_equal = len(co.history) == len(solo.history) and all(
            a.loss == b.loss and a.rho == b.rho and a.energy == b.energy
            and a.t_fl == b.t_fl and a.objective == b.objective
            for a, b in zip(co.history, solo.history)
        )
        per_job.append({
            "job": co.name,
            "tenant": tenant_id(job, i),
            "trajectory_equal": bool(rounds_equal),
            "measurements_equal": co.measurements == solo.measurements,
        })
    ok = all(j["trajectory_equal"] and j["measurements_equal"] for j in per_job)
    return {"jobs": per_job, "ok": bool(ok)}


def trajectory(result: SemComJobResult) -> dict:
    """One job's per-round accuracy and energy trajectory."""
    return {
        "job": result.name,
        "rounds": len(result.history),
        "loss": [h.loss for h in result.history],
        "rho": [h.rho for h in result.history],
        "energy": [h.energy for h in result.history],
        "t_fl": [h.t_fl for h in result.history],
        "objective": [h.objective for h in result.history],
        "proxy_accuracy": [a for _, a in result.measurements],
        "refit_applied": result.refit_applied,
        "refit_round": result.refit_round,
    }


def run_e2e(seed: int, allocator, serve_cfg, specs, rounds, ae, batch, eval_batch,
            device="cuda", log=print) -> dict:
    """The four phases; returns the report (``ok``: every gate held), with
    each phase's wall time in ``wall_s``."""
    device = resolve_device(device)
    executables: dict = {}
    wall = {}

    # phase 1: equivalence at the backend level (feedback would break it)
    t0 = time.perf_counter()
    probe = make_job(specs[0], rounds, ae, batch, eval_batch, device=device)
    eq = check_backend_equivalence(
        fold_seed(seed, 100), probe.cfg.fl, allocator, serve_cfg, upload_bits(probe),
        executables, device,
    )
    wall["equivalence"] = time.perf_counter() - t0
    log(f"[1/4] backend equivalence over {eq['rounds']} rounds: "
        f"hardened X equal = {eq['hardened_x_equal']}, rho allclose = {eq['rho_allclose']}")

    # phase 2: the feedback edge through the virtual-clock service
    t0 = time.perf_counter()
    _, refit = run_refit_loop(
        fold_seed(seed, 200), make_job(specs[0], rounds, ae, batch, eval_batch, device=device),
        serve_cfg, executables,
    )
    wall["refit"] = time.perf_counter() - t0
    log(f"[2/4] refit: applied = {refit['refit_applied']} (round {refit['refit_round']}), "
        f"A(rho) = {refit['fit_a']} * rho^{refit['fit_b']}, monotone = {refit['fit_monotone']}")

    # phase 3: J heterogeneous jobs, one real-clock driver
    t0 = time.perf_counter()
    seed3 = fold_seed(seed, 300)
    jobs = [make_job(s, rounds, ae, batch, eval_batch, device=device) for s in specs]
    results, summary = run_multijob(seed3, jobs, serve_cfg, executables)
    completed = all(len(r.history) == rounds for r in results)
    wall["multijob"] = time.perf_counter() - t0
    log(f"[3/4] {len(results)} concurrent jobs x {rounds} rounds over one driver: "
        f"all completed = {completed}, "
        f"p95 latency = {summary.get('latency_p95_s', 0) * 1e3:.1f}ms, "
        f"occupancy = {summary.get('batch_occupancy_mean', 0):.2f}")

    # phase 4: each job alone must reproduce its co-tenanted trajectory
    t0 = time.perf_counter()
    nonint = check_noninterference(seed3, jobs, results, serve_cfg, executables)
    wall["noninterference"] = time.perf_counter() - t0
    log(f"[4/4] multi-tenant non-interference over {len(jobs)} jobs: as-if-alone = {nonint['ok']}")
    return {
        "equivalence": eq,
        "refit": refit,
        "jobs": [trajectory(r) for r in results],
        "noninterference": nonint,
        "service": summary,
        "wall_s": wall,
        "ok": bool(eq["equivalent"] and refit["ok"] and completed and nonint["ok"]),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--jobs", type=int, default=None,
                    help="concurrent FL jobs in phase 3 (default: all specs)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="test scale: tiny AE, reduced allocator, 2 jobs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    report = run_e2e(args.seed, *harness_config(args.smoke, args.rounds, args.jobs),
                     device=args.device)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
