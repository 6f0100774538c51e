"""Paper Fig. 5: energy and FL time against (N users x K subcarriers).

Counterpart of the reference's ``benchmarks/fig5_users_subcarriers.py``.
Claims: more subcarriers -> energy and time trend down; more users (same K)
-> energy and FL time up.

Grid cells have different (N, K), so they cannot share a batch: each cell
averages over ``n_realisations`` i.i.d. channel draws solved in one
`solve_batch` call. The draws are the port's, so the rows are not the
reference's.
"""
from __future__ import annotations

from ..scenarios import get_family
from .common import run_proposed_batch, weights, write_csv

USERS = (4, 8, 16)
SUBCARRIERS = (20, 40, 60)


def run(quick: bool = True, seed: int = 0, scenario: str = "iid_rayleigh", *, device="cuda",
        allocator=None, out_dir=None):
    w = weights(device=device)
    family = get_family(scenario)
    rows = []
    users = USERS[:2] if quick else USERS
    subs = SUBCARRIERS[:2] if quick else SUBCARRIERS
    n_real = 2 if quick else 4
    for n in users:
        for k in subs:
            pb = family.sample_batch(seed, n_real, N=n, K=k, device=device)
            reps = run_proposed_batch(pb, w, allocator=allocator, device=device)
            # the mean over channel draws, one row per grid cell
            rep = {key: sum(r[key] for r in reps) / n_real for key in reps[0]}
            rows.append({"N": n, "K": k, "n_realisations": n_real, **rep})
    write_csv("fig5_users_subcarriers", rows, out_dir)
    return rows, checks(rows)


def checks(rows) -> dict:
    k0, n0 = rows[0]["K"], rows[-1]["N"]
    e_by_n = [r["energy_total"] for r in rows if r["K"] == k0]
    t_by_n = [r["t_fl"] for r in rows if r["K"] == k0]
    e_by_k = [r["energy_total"] for r in rows if r["N"] == n0]
    return {
        # more users at fixed K => more energy, longer rounds
        "energy_up_with_users": e_by_n[-1] >= e_by_n[0] * 0.9,
        "tfl_up_with_users": t_by_n[-1] >= t_by_n[0] * 0.9,
        # more subcarriers at fixed N => energy "roughly decreasing" (paper)
        "energy_down_with_subcarriers": e_by_k[-1] <= e_by_k[0] * 1.35,
    }
