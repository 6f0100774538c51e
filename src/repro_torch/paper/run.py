"""Run the paper's drivers: one module per figure or table.

Counterpart of the reference's ``benchmarks/run.py`` for the seven paper
drivers (its performance benchmarks are not ported). Prints
``name,us_per_call,derived`` lines (us_per_call: the driver's wall time;
derived: how many of its paper-claim checks pass), then every check on
stderr. A claim that comes out False is printed and counted; a driver that
raises ends the run with a non-zero exit code (the reference's runner
catches the exception and exits 0).

  PYTHONPATH=src python -m repro_torch.paper.run [--full] [--only fig4] [--device cpu] [--out-dir D]
"""
from __future__ import annotations

import argparse
import sys
import time

from . import (
    alg_analysis, fig3_weights, fig4_pmax, fig5_users_subcarriers, fig6_workloads,
    fig8_accuracy, table2_exhaustive,
)

DRIVERS = {
    "fig3_weights": fig3_weights,
    "fig4_pmax": fig4_pmax,
    "fig5_users_subcarriers": fig5_users_subcarriers,
    "fig6_workloads": fig6_workloads,
    "fig8_accuracy": fig8_accuracy,
    "table2_exhaustive": table2_exhaustive,
    "alg_analysis": alg_analysis,
}


def print_checks(all_checks: dict) -> int:
    """Every check on stderr; returns the number that came out False."""
    print("\n--- paper-claim checks ---", file=sys.stderr)
    failures = 0
    for name, checks in all_checks.items():
        for k, v in checks.items():
            status = v if not isinstance(v, bool) else ("PASS" if v else "FAIL")
            failures += v is False
            print(f"{name}.{k}: {status}", file=sys.stderr)
    if failures:
        print(f"\n{failures} claim-check failure(s)", file=sys.stderr)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="full sweep grids")
    ap.add_argument("--only", default=None, help="run the drivers whose name holds this")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default=None, help="where the CSVs go (default experiments/paper_torch)")
    args = ap.parse_args(argv)

    mods = {k: v for k, v in DRIVERS.items() if args.only is None or args.only in k}
    if not mods:
        ap.error(f"--only {args.only!r} matches none of {sorted(DRIVERS)}")
    all_checks = {}
    print("name,us_per_call,derived", flush=True)
    try:
        for name, mod in mods.items():
            t0 = time.perf_counter()
            _, checks = mod.run(quick=not args.full, device=args.device, out_dir=args.out_dir)
            dt_us = (time.perf_counter() - t0) * 1e6
            n_pass = sum(1 for v in checks.values() if v is True)
            n_check = sum(1 for v in checks.values() if isinstance(v, bool))
            print(f"{name},{dt_us:.0f},checks={n_pass}/{n_check}", flush=True)
            all_checks[name] = checks
    finally:
        print_checks(all_checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
