"""Paper §IV-D analyses: Alg. A2's convergence (§IV-D.2) and its runtime
against N and K (§IV-D.1: O((2N + (4NK + 3N + K) I_max) J_max), about
linear in N K for fixed iteration counts).

Counterpart of the reference's ``benchmarks/alg_analysis.py``. A trace
check reads the last two outer iterations, so a cut allocator keeps
``outer_iters >= 2``. Each runtime is the first solve of its shape once
the kernel is built (nothing compiles per shape here); on the card it
measures host dispatch more than arithmetic. The draws are the port's, so
the rows are not the reference's.
"""
from __future__ import annotations

import numpy as np

from .common import sample_scenario, solve_proposed, weights, write_csv


def run(quick: bool = True, seed: int = 0, *, device="cuda", allocator=None, out_dir=None):
    w = weights(device=device)
    rows = []

    # convergence traces over several channels
    n_seeds = 3 if quick else 8
    for s in range(n_seeds):
        params = sample_scenario(seed + s, device=device)
        res, _ = solve_proposed([params], w, "sca", allocator=allocator, device=device)
        tr = res.trace[0].double().cpu().numpy()
        rows.append({"kind": "trace", "seed": s, **{f"s{i}": float(v) for i, v in enumerate(tr)}})

    # runtime against N K
    sizes = [(4, 12), (8, 24)] if quick else [(4, 12), (8, 24), (12, 48), (16, 64)]
    for n, k in sizes:
        params = sample_scenario(seed, N=n, K=k, device=device)
        _, (rep,) = solve_proposed([params], w, "pgd", allocator=allocator, device=device)
        rows.append({"kind": "runtime", "N": n, "K": k, "NK": n * k, "runtime_s": rep["runtime_s"]})
    write_csv("alg_analysis", rows, out_dir)
    return rows, checks(rows)


def converged(row) -> bool:
    """A trace row whose last step is small against its whole descent."""
    steps = sorted((int(k[1:]), v) for k, v in row.items() if k[:1] == "s" and k[1:].isdigit())
    tr = np.asarray([v for _, v in steps], np.float64)
    total = abs(tr[-1] - tr[0]) + 1e-9
    return abs(tr[-1] - tr[-2]) <= 0.35 * total + 0.15


def checks(rows) -> dict:
    traces = [r for r in rows if r["kind"] == "trace"]
    runtimes = [r for r in rows if r["kind"] == "runtime"]
    nk = [r["NK"] for r in runtimes]
    times = [r["runtime_s"] for r in runtimes]
    # runtime should grow clearly sub-quadratically in N K (theory: about linear)
    growth = (times[-1] / max(times[0], 1e-9)) / (nk[-1] / nk[0]) ** 2
    return {
        "all_traces_converge": all(converged(r) for r in traces),
        "runtime_subquadratic_in_NK": growth < 1.0,
    }
