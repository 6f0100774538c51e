"""Shared helpers of the paper's drivers: sampling, timing, the allocator
wrappers and CSV output.

Counterpart of the reference's ``benchmarks/common.py``. Scenarios come
from the port's families (`torch.Generator` draws), so a sweep follows the
reference's laws, not its draws, and the CSVs will not equal the
reference's.

Every solving helper takes ``allocator=`` (None: the reference's
``AllocatorConfig(inner=...)``; an `AllocatorConfig`: its depth, with the
inner each call names) and ``device=`` (the card unless ``"cpu"``; the
scenarios and weights are moved there).

Timing: the reference runs each solve twice, so that JAX compiles before
its timer starts. The port compiles nothing per shape: `ready` builds the
objective kernel once, and ``runtime_s`` is the wall time of the one solve,
between two synchronizes (for a batch, that time over the batch size). On
the card it is mostly host dispatch.

`watch` shows a caller every allocation the helpers make (`chip_smoke.py`
checks them).
"""
from __future__ import annotations

import contextlib
import csv
import pathlib
import time

import torch

from ..core import (
    AllocatorConfig, SystemParams, Weights, solve_batch, stack_params, stack_weights,
)
from ..core import baselines as B
from ..core.system import feasible, report
from ..core.types import tree_map
from ..device import resolve_device
from ..scenarios import get_family

#: where `write_csv` writes unless given a directory (gitignored)
OUT = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "paper_torch"

#: the callbacks `watch` installed, innermost last: the drivers keep the
#: reference's signatures, so the hook reaches the helpers here, and only
#: inside a `watch` block
_WATCHERS: list = []


@contextlib.contextmanager
def watch(fn):
    """Within the block, call ``fn(method, params, weights, alloc, reports)``
    for every allocation a helper makes. ``params`` and ``weights`` carry a
    leading batch axis (one scenario is a batch of one); ``alloc`` is the
    `AllocatorResult` of Alg. A2, or the `Allocation` of a baseline or the
    oracle, batched alike; ``reports`` holds one row dict per scenario."""
    _WATCHERS.append(fn)
    try:
        yield
    finally:
        _WATCHERS.remove(fn)


def notify(method: str, params, w, alloc, reports) -> None:
    if params.g.ndim == 2:
        params, alloc = (tree_map(lambda x: x[None], t) for t in (params, alloc))
    w = tree_map(lambda x: torch.broadcast_to(x, params.g.shape[:1]), w)
    for fn in list(_WATCHERS):
        fn(method, params, w, alloc, reports)


def weights(k1=1.0, k2=1.0, k3=1.0, device="cuda") -> Weights:
    dev = resolve_device(device)
    return Weights(*(torch.tensor(k, dtype=torch.float32, device=dev) for k in (k1, k2, k3)))


def sample_scenario(seed, *, scenario: str = "iid_rayleigh", device="cuda", **kwargs) -> SystemParams:
    """One draw from a registered family: every driver's single-draw entry
    point, so ``scenario`` reaches all of them."""
    return get_family(scenario).sample(seed, device=device, **kwargs)


def sample_sweep(seed, overrides: list[dict], *, scenario: str = "iid_rayleigh", device="cuda",
                 **base_kwargs) -> list[SystemParams]:
    """One draw per sweep point, all from the same seed and family: only the
    per-point ``overrides`` (e.g. ``{"p_max_dbm": 24.0}``) move between
    points, so a sweep isolates the swept knob from channel randomness. This
    holds because the families draw nothing that depends on those knobs."""
    fam = get_family(scenario)
    return [fam.sample(seed, device=device, **{**base_kwargs, **o}) for o in overrides]


def ready(device="cuda") -> torch.device:
    """The resolved device; on the card, the objective kernel built and
    loaded, so that no timed solve pays for it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels.fedsem_objective import kernel

        kernel.load()
    return dev


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, **kw):
    """(fn(*args, **kw), wall seconds), the clock read after the card has
    finished the work."""
    _synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _synchronize()
    return out, time.perf_counter() - t0


def config_for(inner: str, allocator: AllocatorConfig | None) -> AllocatorConfig:
    return AllocatorConfig(inner=inner) if allocator is None else allocator._replace(inner=inner)


def _to(tree, dev):
    return tree_map(lambda x: x.to(dev), tree)


def reports_of(params, w, alloc) -> list[dict]:
    """`report` and `feasible` of one scenario or a batch, as one row dict
    of python numbers per scenario."""
    cols = {k: v.detach().reshape(-1).cpu().tolist() for k, v in report(params, w, alloc).items()}
    cols["feasible"] = feasible(params, alloc).reshape(-1).cpu().tolist()
    n = len(cols["objective"])
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


def solve_proposed(scenarios, w, inner: str = "sca", *, allocator=None, device="cuda",
                   weights_batched: bool = False):
    """Alg. A2 on same-shape scenarios in one `solve_batch` call: (result,
    one report row per scenario). ``scenarios`` is a batch-stacked
    `SystemParams` or a list of single ones; ``runtime_s`` is the solve's
    wall time over the batch size."""
    dev = ready(device)
    pb = scenarios if isinstance(scenarios, SystemParams) else stack_params(scenarios)
    pb, w = _to(pb, dev), _to(w, dev)
    res, dt = timed(solve_batch, pb, w, config_for(inner, allocator),
                    weights_batched=weights_batched)
    reps = reports_of(pb, w, res.alloc)
    for rep in reps:
        rep["runtime_s"] = dt / len(reps)
    notify("proposed", pb, w, res, reps)
    return res, reps


def run_proposed(params, w, inner: str = "sca", *, allocator=None, device="cuda") -> dict:
    """One scenario's report row."""
    return run_proposed_batch([params], w, inner, allocator=allocator, device=device)[0]


def run_proposed_batch(scenarios, w, inner: str = "sca", *, allocator=None, device="cuda"):
    """Same-shape scenarios in one batched solve: one report row each."""
    return solve_proposed(scenarios, w, inner, allocator=allocator, device=device)[1]


def run_proposed_weights_batch(params, weights_list, inner: str = "sca", *, allocator=None,
                               device="cuda"):
    """One scenario under many weight settings in one batched solve
    (``solve_batch(weights_batched=True)``): one report row per setting."""
    weights_list = list(weights_list)
    pb = stack_params([params] * len(weights_list))
    wb = stack_weights([_to(w, pb.device) for w in weights_list])
    return solve_proposed(pb, wb, inner, allocator=allocator, device=device,
                          weights_batched=True)[1]


#: the paper's four baselines (§V-B), as name -> (params, weights, seed) -> Allocation
BASELINES = {
    "equal": lambda p, w, seed: B.equal_allocation(p),
    "comm_only": B.comm_opt_only,
    "comp_only": lambda p, w, seed: B.comp_opt_only(p, w),
    "random": lambda p, w, seed: B.random_allocation(p, seed),
}


def run_baselines(params, w, seed, *, names=tuple(BASELINES), device="cuda") -> dict:
    """{name: report row} of the baselines on one scenario. Baselines can
    violate P1's constraints (comm_only keeps rho = 1 and misses the SemCom
    deadline at low p_max), so each row says whether it is feasible, and the
    claim checks compare like with like."""
    dev = resolve_device(device)
    params, w = _to(params, dev), _to(w, dev)
    out = {}
    for name in names:
        alloc = BASELINES[name](params, w, seed)
        reps = reports_of(params, w, alloc)
        notify(name, params, w, alloc, reps)
        out[name] = reps[0]
    return out


def write_csv(name: str, rows: list[dict], out_dir=None) -> pathlib.Path:
    out = pathlib.Path(out_dir) if out_dir is not None else OUT
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.csv"
    if not rows:
        return path
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        wtr = csv.DictWriter(f, fieldnames=keys)
        wtr.writeheader()
        wtr.writerows(rows)
    return path
