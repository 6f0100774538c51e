"""Paper Fig. 6: total energy against the SemCom task workload (multiples
of C_n).

Counterpart of the reference's ``benchmarks/fig6_workloads.py``. Claim:
heavier semantic payloads -> higher SemCom energy; FL energy about flat.
Every point is drawn from the same seed (only the payload moves) and solved
in one batched call; the mixed-groups point (Fig. 6a: 5 groups of 2
devices, needs N = 10) is one more solve. The draws are the port's, so the
rows are not the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import run_proposed, run_proposed_batch, sample_scenario, sample_sweep, weights, write_csv

MULTIPLES = (1.0, 2.0, 4.0, 8.0, 16.0)
BASE_C = 1e6  # the "light" workload, paper §V-D


def run(quick: bool = True, seed: int = 0, scenario: str = "iid_rayleigh", *, device="cuda",
        allocator=None, out_dir=None):
    w = weights(device=device)
    rows = []
    sweep = MULTIPLES[::2] if quick else MULTIPLES
    params_list = sample_sweep(
        seed, [{"C_round_bits": BASE_C * mult, "L_rounds": 10} for mult in sweep],
        scenario=scenario, device=device,
    )
    for mult, rep in zip(sweep, run_proposed_batch(params_list, w, allocator=allocator,
                                                   device=device)):
        rows.append({"workload_multiple": mult, **rep})

    params = sample_scenario(seed, scenario=scenario, device=device)
    group_C = np.repeat([1.0, 2.0, 4.0, 8.0, 16.0], 2) * BASE_C * 10
    params = dataclasses.replace(
        params, C=torch.as_tensor(group_C, dtype=torch.float32, device=params.device))
    rep = run_proposed(params, w, allocator=allocator, device=device)
    rows.append({"workload_multiple": -1.0, **rep})  # -1 = mixed groups
    write_csv("fig6_workloads", rows, out_dir)
    return rows, checks(rows)


def checks(rows) -> dict:
    e = [r["energy_semcom"] for r in rows if r["workload_multiple"] > 0]
    return {"semcom_energy_up_with_workload": e[-1] >= e[0]}
