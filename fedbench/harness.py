"""What every cell shares: finding a cell's files by the names in
`BENCHMARK.json`, seeds, the weights, the device record, the result line and
the check that nothing of JAX was loaded.

A cell names a configuration and a traffic mix. The harness finds, by name:
the configuration's file (``configs`` entry ``file``) and its plain
reference beside it (the same path ending in ``.py``); the traffic mix
``fedbench/traffic/<traffic>.json``, whose ``kind`` names the driver
(``fedbench/drivers/<kind>.py``); the cell's limits
``fedbench/limits/<workload>.json``; each per-layer metric's reader
``fedbench/metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys

import numpy as np

#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: where the program's and the harness's caches go, inside the checkout
CACHE_DIR = pathlib.Path("build") / "fedbench_cache"


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """A Python file found by name, imported from its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of `BENCHMARK.json`'s ``workloads`` with its files."""

    root: pathlib.Path
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    limits: dict          # the cell's limits: {number: {"limit": x, ...}}
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries
    reference_path: pathlib.Path

    def reference(self):
        """The configuration's plain reference module."""
        return load_module(self.reference_path, "fedbench_reference_" + self.config["name"].replace("-", "_").replace(".", "_"))


def _in_cell(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: an end-to-end metric without a
    ``workloads`` key is every cell's; a per-layer metric names its cells."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        raise ValueError(f"per-layer metric {metric['name']!r} lists no workloads: "
                         "name the cells whose code finds something to read")
    return True


def find_cell(root: pathlib.Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root``'s `BENCHMARK.json`, with its files."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"known: {', '.join(w['name'] for w in bench['workloads'])}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    file = root / conf["file"]
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload)]
    return Cell(
        root=root, name=workload, chips=int(entry["chips"]), config=load_json(file),
        traffic=load_json(root / "fedbench" / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(root / "fedbench" / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=per_layer, reference_path=file.with_suffix(".py"),
    )


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, tokens, scenarios, sampling),
    derived from the run's seed (any whole number)."""
    words = [int(seed) % 2**32, (int(seed) >> 32) % 2**32, *map(ord, purpose)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def flatten_spec(spec: dict, prefix=()):
    """The leaves of a tree spec (nested dicts whose leaves are dicts with a
    ``shape``), as (path, leaf) in depth-first order."""
    for key, node in spec.items():
        if "shape" in node:
            yield prefix + (key,), node
        else:
            yield from flatten_spec(node, prefix + (key,))


def spec_numel(spec: dict, matmul_only: bool = False) -> int:
    return sum(math.prod(leaf["shape"]) for _, leaf in flatten_spec(spec)
               if leaf.get("matmul") or not matmul_only)


#: each leaf of the weights starts on a multiple of this many elements, so
#: every leaf is aligned for the kernels' 16-byte (TMA) loads
ALIGN = 128


def make_tree(spec: dict, gen, dtype, device) -> dict:
    """The weights of a tree spec, drawn from ``gen`` on ``device`` in a few
    large calls: one buffer of standard normals in ``dtype``, each leaf a
    view of it, scaled and shifted in place to its law (``std``, ``mean``)."""
    import torch

    leaves = list(flatten_spec(spec))
    offsets, total = [], 0
    for _, leaf in leaves:
        offsets.append(total)
        total += -(-math.prod(leaf["shape"]) // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    step = 2**30
    for lo in range(0, total, step):
        buf[lo:lo + step].normal_(generator=gen)
    tree: dict = {}
    for (path, leaf), off in zip(leaves, offsets):
        n = math.prod(leaf["shape"])
        t = buf[off:off + n].view(leaf["shape"])
        t.mul_(leaf.get("std", 1.0)).add_(leaf.get("mean", 0.0))
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_record(device, chips: int) -> dict:
    """The result line's ``device``: the card's name, the cards the run
    uses and the peak of the fullest."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": dev.type, "kind": dev.type, "count": chips, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    `FORBIDDEN_MODULES`, compared whole: ``repro_torch`` is not ``repro``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, compared): each number held to its limit (``value <=
    limit``); a number that is not finite fails."""
    compared = {}
    ok = True
    for name, entry in limits.items():
        value = readings[name]
        limit = entry["limit"]
        good = math.isfinite(value) and value <= limit
        ok &= good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared


def read_metrics(cell: Cell, record) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        mod = load_module(cell.root / "fedbench" / "metrics" / f"{m['name']}.py",
                          "fedbench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(correct, attempted, failed, metrics, device, compared, breakdown=None) -> str:
    """The last line of standard output: the contract's keys, ``compared``
    last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = compared
    return json.dumps(line)


def compared_lines(compared: dict) -> list[str]:
    """The numbers compared, one a line, for the end of standard error."""
    return [f"compared {name}: {c['value']!r} limit {c['limit']!r}" for name, c in compared.items()]
