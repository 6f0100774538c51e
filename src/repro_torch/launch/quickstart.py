"""Quickstart: solve one FedSem resource-allocation scenario and compare it
with the paper's four baselines.

Counterpart of the reference's ``examples/quickstart.py``, plus ``--device``
(the card unless ``--device cpu``). The scenario is the port's Table-I draw
(N 10, K 50) from seed 0, so the numbers are not the reference's.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..core import AllocatorConfig, Weights, sample_params, solve
from ..core import baselines as B
from ..core.system import feasible, report
from ..paper.common import ready


def run(device="cuda", allocator: AllocatorConfig | None = None):
    """(params, Alg. A2's result, {method: report}) on one Table-I scenario;
    ``allocator`` defaults to the example's ``AllocatorConfig(inner="sca")``."""
    dev = ready(device)
    params = sample_params(0, device=dev)
    w = Weights.ones(dev)
    res = solve(params, w, allocator or AllocatorConfig(inner="sca"))
    rows = {"proposed (Alg. A2)": report(params, w, res.alloc)}
    rows["equal"] = report(params, w, B.equal_allocation(params))
    rows["comm-only"] = report(params, w, B.comm_opt_only(params, w, 0))
    rows["comp-only"] = report(params, w, B.comp_opt_only(params, w))
    rows["random"] = report(params, w, B.random_allocation(params, 0))
    return params, res, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    params, res, rows = run(args.device)

    print(f"{'method':22s} {'objective':>10s} {'energy J':>9s} {'T_FL s':>8s} {'rho':>5s}")
    for name, r in rows.items():
        print(f"{name:22s} {float(r['objective']):10.3f} "
              f"{float(r['energy_total']):9.3f} {float(r['t_fl']):8.3f} "
              f"{float(r['rho']):5.2f}")
    print("\nallocation feasible:", bool(feasible(params, res.alloc)))
    print("objective trace (Alg. A2 iters):", [round(float(x), 3) for x in res.trace])
    print("subcarriers per device:", torch.sum(res.alloc.X, dim=1).int().tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
