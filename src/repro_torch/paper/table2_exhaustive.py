"""Paper Table II: proposed against approximate exhaustive search on a toy
(N = 4, K = 5) instance. Claims: exhaustive finds a (somewhat) better
objective; proposed is orders of magnitude faster.

Counterpart of the reference's ``benchmarks/table2_exhaustive.py``, with its
grid reductions: per-device total power levels (spread equally over the
device's subcarriers) instead of per-(n, k) powers; X enumerated exactly
(4^5 = 1024 assignments), each sweep launching the objective kernel on the
card. The instance is the port's draw, so the rows are not the
reference's.
"""
from __future__ import annotations

import numpy as np

from ..core.exhaustive import solve_exhaustive
from .common import (
    notify, ready, run_baselines, run_proposed, sample_scenario, timed, weights, write_csv,
)

#: seconds in a year, as the reference rounds it
YEAR_S = 3.15e7


def run(quick: bool = True, seed: int = 0, *, device="cuda", allocator=None, out_dir=None):
    dev = ready(device)
    w = weights(device=dev)
    params = sample_scenario(seed, N=4, K=5, device=dev)

    prop = run_proposed(params, w, allocator=allocator, device=dev)
    prop_pgd = run_proposed(params, w, "pgd", allocator=allocator, device=dev)
    eq = run_baselines(params, w, seed, names=("equal",), device=dev)["equal"]

    levels = 3 if quick else 4
    ex, ex_time = timed(
        solve_exhaustive, params, w,
        f_levels=np.linspace(0.25e9, 2e9, levels + 1),
        p_levels_dbm=np.linspace(4, 20, levels),
        rho_levels=np.linspace(0.2, 1.0, 5),
    )
    notify("exhaustive", params, w, ex.alloc, [{"objective": float(ex.value)}])

    rows = [
        {"method": "equal", "objective": eq["objective"], "runtime_s": 0.0},
        {"method": "proposed(sca)", "objective": prop["objective"],
         "runtime_s": prop["runtime_s"]},
        {"method": "proposed(pgd)", "objective": prop_pgd["objective"],
         "runtime_s": prop_pgd["runtime_s"]},
        {"method": "approx_exhaustive", "objective": float(ex.value),
         "runtime_s": ex_time, "n_evaluated": ex.n_evaluated},
    ]
    # The runtime claim is about scaling: on the toy instance the vectorised
    # grid search is fast, but exhaustive cost is Lf^N Lp^N Lr N^K while
    # Alg. A2 is polynomial. Project the default scenario (N 10, K 50) on
    # the measured evaluations per second.
    evals_per_s = ex.n_evaluated / max(ex_time, 1e-9)
    projected_evals = (4.0**10) * (3.0**10) * 5 * (10.0**50)
    rows.append({
        "method": "exhaustive@N=10,K=50 (projected)",
        "objective": float("nan"), "runtime_s": projected_evals / evals_per_s,
    })
    write_csv("table2_exhaustive", rows, out_dir)
    return rows, checks(rows)


def checks(rows) -> dict:
    by = {r["method"]: r for r in rows}
    best_prop = min(by["proposed(sca)"]["objective"], by["proposed(pgd)"]["objective"])
    ex = by["approx_exhaustive"]["objective"]
    projected_years = by["exhaustive@N=10,K=50 (projected)"]["runtime_s"] / YEAR_S
    return {
        "exhaustive_not_much_better": ex >= best_prop - 0.35 * abs(best_prop),
        "proposed_beats_equal": best_prop < by["equal"]["objective"],
        "exhaustive_intractable_at_scale": projected_years > 1e6,
    }
