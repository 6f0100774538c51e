"""Paper Fig. 8: (a) kappa3 against the chosen compression rate rho; (b)
accuracy against rho for the two concave fits (YOLOv5, and the YOLOv3
stand-in).

Counterpart of the reference's ``benchmarks/fig8_accuracy.py``. The
reference's docstring also promises the FL autoencoder's re-fit curve,
which its code never reads; the port follows the code (ROADMAP §3). Part
(a) is one weights-batched solve of one scenario, the port's draw, so its
rows are not the reference's; part (b) is the two fits on a rho grid.
"""
from __future__ import annotations

import numpy as np

from ..core.accuracy import default_accuracy, yolov3_accuracy
from ..device import resolve_device
from .common import run_proposed_weights_batch, sample_scenario, weights, write_csv

KAPPA3 = (0.05, 0.2, 1.0, 5.0, 20.0)


def run(quick: bool = True, seed: int = 0, scenario: str = "iid_rayleigh", *, device="cuda",
        allocator=None, out_dir=None):
    params = sample_scenario(seed, scenario=scenario, device=device)
    rows = []
    sweep = KAPPA3[1:4] if quick else KAPPA3
    for k3, rep in zip(sweep, run_proposed_weights_batch(
            params, [weights(k3=k3, device=device) for k3 in sweep],
            allocator=allocator, device=device)):
        rows.append({"kappa3": k3, **rep})
    write_csv("fig8a_kappa3_rho", rows, out_dir)

    dev = resolve_device(device)
    v5, v3 = default_accuracy(dev), yolov3_accuracy(dev)
    acc_rows = [
        {"rho": float(rho), "yolov5_fit": float(v5.value(rho)), "yolov3_fit": float(v3.value(rho))}
        for rho in np.linspace(0.05, 1.0, 20)
    ]
    write_csv("fig8b_accuracy_vs_rho", acc_rows, out_dir)
    return rows + acc_rows, checks(rows + acc_rows)


def checks(rows) -> dict:
    rhos = [r["rho"] for r in rows if "kappa3" in r]
    a5 = [r["yolov5_fit"] for r in rows if "yolov5_fit" in r]
    return {
        "rho_nondecreasing_in_k3": all(
            rhos[i + 1] >= rhos[i] - 1e-6 for i in range(len(rhos) - 1)
        ),
        "accuracy_concave_increasing": all(a5[i + 1] > a5[i] for i in range(len(a5) - 1)),
    }
