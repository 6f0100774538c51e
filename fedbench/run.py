"""Run one cell of `BENCHMARK.json` on the card and print the result line.

    python3 -m fedbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics; with ``--trace 1`` the window runs under the
device trace and the metrics are its per-layer ones, with ``breakdown``.
Exits 2 without enough CUDA cards, 3 if the process loaded JAX or the JAX
package, 1 on any other failure; none of these prints a result line.
"""
from __future__ import annotations

import argparse
import importlib
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m fedbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare_env(root: pathlib.Path) -> None:
    """Caches inside the checkout, at fixed paths (set before CUDA starts);
    the program on the path."""
    from fedbench.harness import CACHE_DIR

    cache = root / CACHE_DIR
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Drive one cell on ``device``: the driver named by the traffic's
    ``kind`` returns its outcome (the harness's look for a card is not
    made here)."""
    driver = importlib.import_module(f"fedbench.drivers.{cell.traffic['kind']}")
    return driver.run(cell, seed=seed, seconds=seconds, trace=trace, device=device)


def main(argv=None) -> int:
    args = parse(argv)
    from fedbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    prepare_env(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fedbench: the cell {cell.name} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"fedbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    print(f"fedbench: {harness.power_limit()}", file=sys.stderr)
    for line in harness.compared_lines(out["compared"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"], out["failed"], out["metrics"],
                              out["device"], out["compared"], out.get("breakdown")))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
