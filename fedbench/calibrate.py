"""Readings for a cell's limits, many seeds in one process (set-up paid
once): the program's numbers on each seed and the control's (and, for an
allocation cell, the planted faults') on some of them. One JSON line a seed.

    python3 -m fedbench.calibrate --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3]

For a prefill cell a seed runs one whole cycle of the traffic's lengths
through the program (the cell's own load) and compares one request of each
length, as a run does; the control is the plain reference with every
product in fp8 (`yardstick.plain`), read against the float32 reference on
the same prompts. For an allocation cell a seed runs one solve of one batch;
the control is the program's answer rounded to bfloat16 at every returned
number (f, P, rho and the reported objective), the least a bf16 solver
changes; the faults (`fedbench.faults`) are half of the batch answered with
the other half's allocations, one scenario's subcarrier moved to another
device, and three planted in the solver: every Adam step returning its
state unchanged, every step reversed, and the gradient of the power logits
lost.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from fedbench import harness
from fedbench.run import ROOT, prepare_env


def prefill_seed(cell, seed, device, control: bool) -> dict:
    import torch

    from fedbench.drivers.prefill import Setup
    from fedbench.yardstick import logits as cmp

    st = Setup(cell, seed, device)
    kept = {}
    for L in st.lengths:
        off = st.next_offset(L)
        out = st.prefill(off, L)
        kept[L] = (off, out[0, st.where[L]])
        del out
    st.lm = None
    torch.cuda.empty_cache()
    refs = {L: st.reference(off, L) for L, (off, _) in kept.items()}
    line = {"program": cmp.readings([(got, refs[L]) for L, (_, got) in kept.items()])}
    if control:
        line["control_fp8"] = cmp.readings([(st.reference(off, L, fp8=True), refs[L])
                                            for L, (off, _) in kept.items()])
    return line


def alloc_seed(cell, seed, device, control: bool) -> dict:
    import torch

    import repro_torch.core as core
    from repro_torch.core.types import tree_map

    from fedbench import faults
    from fedbench.drivers.fl_alloc import Setup, leaves

    st = Setup(cell, seed, device)
    solve = lambda: core.solve_batch(st.params[0], st.weights, st.cfg, st.accuracy)
    score = lambda res: core.batch_objectives(st.params[0], st.weights, res.alloc, st.accuracy)
    judge = lambda res: st.judge(0, leaves(res.alloc), score(res))
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    line = {"solve_s": time.perf_counter() - t0, "program": judge(res)}
    if not control:
        return line
    bf16 = lambda x: x.to(torch.bfloat16).to(x.dtype)
    rounded = {k: (v if k == "X" else bf16(v)) for k, v in leaves(res.alloc).items()}
    line["control_bf16"] = st.judge(0, rounded, bf16(score(res)))
    for transform in (faults.half_batch, faults.answer_altered):
        line[f"fault_{transform.__name__}"] = judge(transform(tree_map(torch.clone, res), st.B))
    for fault in (faults.steps_unchanged, faults.steps_reversed, faults.power_gradient_lost):
        with faults.planted(fault):
            line[f"fault_{fault.__name__}"] = judge(solve())
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m fedbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = harness.find_cell(ROOT, args.workload)
    prepare_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("fedbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    one = {"prefill": prefill_seed, "fl_alloc": alloc_seed}[cell.traffic["kind"]]
    print(json.dumps({"workload": cell.name, "card": harness.power_limit()}), flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = one(cell, seed, device, seed in args.control_seeds)
        print(json.dumps(dict(seed=seed, seconds=time.perf_counter() - t0, **line)), flush=True)
        torch.cuda.empty_cache()
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"fedbench.calibrate: loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
