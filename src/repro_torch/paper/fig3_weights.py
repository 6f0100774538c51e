"""Paper Fig. 3: energy, time and accuracy against the weights k1, k2, k3.

Counterpart of the reference's ``benchmarks/fig3_weights.py``. Claims
(paper §V-A):
  (a) k1 up -> total energy down, FL time up;
  (b) k2 up -> FL time down, energy up;
  (c) k3 up -> SemCom tx energy up (rho up), FL comp/tx energy about flat.

The whole 3 x len(sweep) grid is one `solve_batch` call with a batched
weights axis (``weights_batched=True``). The scenario is the port's draw, so
the rows are not the reference's.
"""
from __future__ import annotations

from .common import run_proposed_weights_batch, sample_scenario, weights, write_csv

SWEEP = (0.25, 1.0, 4.0, 16.0)


def run(quick: bool = True, seed: int = 0, scenario: str = "iid_rayleigh", *, device="cuda",
        allocator=None, out_dir=None):
    params = sample_scenario(seed, scenario=scenario, device=device)
    sweep = SWEEP[1:3] if quick else SWEEP
    points = []
    for which in ("kappa1", "kappa2", "kappa3"):
        for val in sweep:
            kw = {"k1": 1.0, "k2": 1.0, "k3": 1.0}
            kw["k" + which[-1]] = val
            points.append((which, val, weights(**kw, device=device)))
    reports = run_proposed_weights_batch(params, [w for _, _, w in points],
                                         allocator=allocator, device=device)
    rows = [
        {"sweep": which, "value": val, **rep}
        for (which, val, _), rep in zip(points, reports)
    ]
    write_csv("fig3_weights", rows, out_dir)
    return rows, checks(rows)


def checks(rows) -> dict:
    def series(which, field):
        return [r[field] for r in rows if r["sweep"] == which]

    return {
        "k1_energy_down": series("kappa1", "energy_total")[-1]
        <= series("kappa1", "energy_total")[0] * 1.15,
        "k2_time_down": series("kappa2", "t_fl")[-1] <= series("kappa2", "t_fl")[0] * 1.15,
        "k3_rho_up": series("kappa3", "rho")[-1] >= series("kappa3", "rho")[0] - 1e-6,
        "k3_semcom_up": series("kappa3", "energy_semcom")[-1]
        >= series("kappa3", "energy_semcom")[0] * 0.85,
    }
