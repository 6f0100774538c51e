#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FedSem on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json] [--profile]

Phases (any failure exits non-zero; nothing is skipped and nothing runs on
the CPU in place of the card):

1. build the CUDA kernel of `repro_torch.kernels.fedsem_objective` from the
   sources in this checkout (nvcc, sm_90a) and print ptxas' report;
2. hold the kernel against its plain PyTorch version on the card at the
   shapes the solver gives it ((B, G, N) = (16, 3, 10) for the multi-start
   selection, (48, 1, 10) for the per-iteration trace), at the exhaustive
   sweep's (64, 8192, 8), and `objective_grid` at (G, N) = (1024, 10); with
   masked rows, per-row weights and the feasibility mask on and off. The
   +inf mask must agree exactly and finite scores to rtol 5e-7, atol 1e-5.
   Each is timed with CUDA events: on the device (launches captured in a
   CUDA graph and replayed) beside its memory bound, and per eager call;
3. the slice: draw 16 Table-I scenarios (N = 10, K = 50, `iid_rayleigh`) on
   the card and run `solve_batch` under ``AllocatorConfig(inner="pgd")``
   (the serving config) and the default ``AllocatorConfig()`` (SCA). Every
   leaf must be finite, each hardened X binary with every subcarrier owned
   once and every device owning one, every scenario feasible, the kernel
   launched at least ``outer_iters + 1`` times per solve, and
   ``use_kernel_objective=False`` must give the identical X, P and rho. A
   small input solved on the card and on the CPU must give the same X.

With ``--profile``, one short solve per config (cut depth) also runs under
`torch.profiler`, for the device's busy share. The last lines are the
kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 5e-7, 1e-5
XI, ETA, AB = 1e-28, 10, (0.6356, 0.4025)
#: floating-point operations per (candidate, device) of eq. 13 as the kernel
#: evaluates it (divisions, products, sums, compares; exp/log counted once)
OPS_PER_ELEMENT = 24


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, iters: int = 20) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph and replayed, so no host time sits between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters) / reps


def grid_inputs(gen, B, G, N, device):
    """Candidate grids and parameter rows in the ranges of the CPU tests,
    with masked rows (device 0 always real) and per-row weights."""
    import torch

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    f = u((B, G, N), 1e8, 2e9)
    p = u((B, G, N), 1e-3, 0.1)
    r = u((B, G, N), 1e5, 3e7)
    rho = u((B, G), 0.05, 1.0)
    rows = [u((B, N), 1e3, 1e4), u((B, N), 1e5, 1e6), u((B, N), 1e5, 1e6), u((B, N), 1e5, 1e6)]
    tsc = torch.full((B, N), 0.5, device=device)
    fmax = torch.full((B, N), 2e9, device=device)
    mask = (torch.rand((B, N), generator=gen, device=device) > 0.4).float()
    mask[:, 0] = 1.0
    kap = (torch.linspace(0.5, 2.0, B, device=device), torch.ones(B, device=device),
           torch.full((B,), 1.3, device=device))
    return (f, p, r, rho, *rows, tsc, fmax), mask, kap


def compare(got, want, what: str) -> float:
    """inf mask exactly, finite scores to RTOL/ATOL; returns max abs error."""
    import torch

    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(torch.equal(torch.isinf(got), torch.isinf(want)), f"{what}: +inf masks differ")
    check(not bool(torch.isnan(got).any()), f"{what}: kernel produced nan")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    lim = ATOL + RTOL * want[fin].abs()
    check(bool((err <= lim).all()), f"{what}: max abs err {float(err.max())} beyond rtol {RTOL}, atol {ATOL}")
    return float(err.max()) if err.numel() else 0.0


def bound(B, G, N, check_feasible):
    """(ms, 'bytes'|'operations'): the least time for eq. 13 on B x G x N.

    Bytes: f, p, r and rho read once, the (B, G) score written once, the
    five (B,) scalars, and the (B, N) rows the function reads: c, d, D, C
    and the device mask, plus t_sc_max and f_max with the feasibility mask.
    """
    rows = 7 if check_feasible else 5
    nbytes = 4 * (3 * B * G * N + B * G + rows * B * N + 5 * B + B * G)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT * B * G * N / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(device):
    """Phase 2: kernel vs plain version, timed. Returns per-case records."""
    import torch

    from repro_torch.kernels.fedsem_objective import kernel, ref

    gen = torch.Generator(device=device).manual_seed(1234)
    cases = []
    ab = tuple(torch.tensor(v, device=device) for v in AB)
    for B, G, N in ((16, 3, 10), (48, 1, 10), (64, 8192, 8)):
        args, mask, kap = grid_inputs(gen, B, G, N, device)
        for feas in (True, False):
            kw = dict(xi=XI, eta=ETA, check_feasible=feas)
            run_k = lambda: kernel.objective_batch(*args, mask, *kap, *AB, **kw)
            run_p = lambda: ref.objective_grid_batch(*args, *kap, accuracy_ab=ab, dev_mask=mask, **kw)
            err = compare(run_k(), run_p(), f"objective_batch{(B, G, N)} feasible={feas}")
            prep = kernel.prepare(*args, mask, *kap, *AB, **kw)
            iters = 200 if G * B < 10000 else 50
            cases.append(dict(
                entry="objective_batch", shape=[B, G, N], check_feasible=feas, max_abs_err=err,
                ms=graph_ms(lambda: kernel.launch(prep)), plain_ms=graph_ms(run_p),
                wrapper_ms=cuda_ms(run_k, iters), plain_eager_ms=cuda_ms(run_p, iters),
                **dict(zip(("bound_ms", "bound_by"), bound(B, G, N, feas))),
            ))
    # objective_grid: one scenario, feasibility on, half the devices masked
    G, N = 1024, 10
    args, _, _ = grid_inputs(gen, 1, G, N, device)
    one = [a[0] for a in args]
    mask = torch.tensor([1.0] * 5 + [0.0] * 5, device=device)
    scal = dict(xi=XI, eta=ETA, k1=0.8, k2=1.0, k3=1.2, a_acc=AB[0], b_acc=AB[1])
    run_k = lambda: kernel.objective_grid(*one, mask, **scal)
    kap = [torch.tensor(v, device=device) for v in (0.8, 1.0, 1.2)]
    run_p = lambda: ref.objective_grid(*one, XI, ETA, *kap, ab, mask)
    err = compare(run_k(), run_p(), "objective_grid(1024, 10)")
    prep = kernel.prepare(*(a[None] for a in one), mask[None], 0.8, 1.0, 1.2, *AB, xi=XI, eta=ETA)
    cases.append(dict(
        entry="objective_grid", shape=[1, G, N], check_feasible=True, max_abs_err=err,
        ms=graph_ms(lambda: kernel.launch(prep)), plain_ms=graph_ms(run_p),
        wrapper_ms=cuda_ms(run_k, 200), plain_eager_ms=cuda_ms(run_p, 200),
        **dict(zip(("bound_ms", "bound_by"), bound(1, G, N, True))),
    ))
    torch.cuda.synchronize()
    return cases


def check_allocation(params, res, what: str) -> None:
    import torch

    from repro_torch.core.system import feasible

    a = res.alloc
    for name in ("f", "P", "X", "rho"):
        check(bool(torch.isfinite(getattr(a, name)).all()), f"{what}: non-finite {name}")
    check(bool(torch.isfinite(res.trace).all()), f"{what}: non-finite trace")
    X = a.X
    check(bool(((X == 0) | (X == 1)).all()), f"{what}: X is not binary")
    check(bool((X.sum(dim=-2) == params.sc_mask).all()), f"{what}: a subcarrier not owned exactly once")
    check(bool((X.sum(dim=-1) >= 1).all()), f"{what}: a device owns no subcarrier")
    check(bool(feasible(params, a).all()), f"{what}: infeasible allocation")


def phase_slice(device):
    """Phase 3: `solve_batch` at Table-I width on the card."""
    import torch

    from repro_torch.core import AllocatorConfig, Weights, solve_batch
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.core.types import tree_map
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.scenarios import get_family

    fam = get_family("iid_rayleigh")
    params = fam.sample_batch(0, 16, N=10, K=50, device=device)
    check(params.g.is_cuda and params.g.shape == (16, 10, 50), "scenarios not drawn on the card")
    w = Weights.ones(device)
    configs = {"pgd": AllocatorConfig(inner="pgd"), "sca": AllocatorConfig()}

    solves = {}
    kernel.launches = 0                      # the main path starts here
    for name, cfg in configs.items():
        before = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batch(params, w, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernel.launches - before
        check_allocation(params, res, f"solve_batch[{name}]")
        check(n >= cfg.outer_iters + 1,
              f"solve_batch[{name}]: {n} kernel launches < outer_iters + 1 = {cfg.outer_iters + 1}")
        solves[name] = dict(res=res, wall_s=wall, launches=n)
        print(f"solve_batch[{name}] B=16 N=10 K=50: {wall:.3f} s wall, {n} kernel launches", flush=True)
    main_path_launches = kernel.launches     # ... and ends here

    for name, cfg in configs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = solve_batch(params, w, cfg._replace(use_kernel_objective=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        on = solves[name]["res"].alloc
        for leaf in ("X", "P", "rho"):
            check(torch.equal(getattr(off.alloc, leaf), getattr(on, leaf)),
                  f"solve_batch[{name}]: use_kernel_objective=False changes {leaf}")
        solves[name]["plain_scoring_wall_s"] = wall
        print(f"solve_batch[{name}] use_kernel_objective=False: {wall:.3f} s wall, "
              "identical X, P, rho", flush=True)
    check(kernel.launches == main_path_launches, "the plain scoring path launched the kernel")

    # the port on the card against the port on the CPU, on a small input
    small_cfg = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=80))
    small = fam.sample_batch(7, 2, N=4, K=12, device="cpu")
    cpu = solve_batch(small, Weights.ones(), small_cfg)
    gpu = solve_batch(tree_map(lambda x: x.to(device), small), w, small_cfg)
    check(torch.equal(gpu.alloc.X.cpu(), cpu.alloc.X), "card and CPU disagree on a small input's X")
    print("small input (B=2, N=4, K=12): card and CPU give the same hardened X", flush=True)
    return {k: {kk: vv for kk, vv in v.items() if kk != "res"} for k, v in solves.items()}, \
        main_path_launches


def phase_profile(device):
    """Where a solve's time goes: one short solve per config (the default
    configs' step structure at cut depth) under `torch.profiler`, with the
    device's busy time against the unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import AllocatorConfig, Weights, solve_batch
    from repro_torch.core.p5 import P5Config
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.scenarios import get_family

    params = get_family("iid_rayleigh").sample_batch(0, 16, N=10, K=50, device=device)
    w = Weights.ones(device)
    configs = {
        "pgd": AllocatorConfig(inner="pgd", outer_iters=1, pgd=PGDConfig(steps=100)),
        "sca": AllocatorConfig(outer_iters=1, p5=P5Config(outer_iters=1, inner_iters=100),
                               pgd=PGDConfig(steps=100)),
    }
    out = {}
    for name, cfg in configs.items():
        solve_batch(params, w, cfg)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_batch(params, w, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve_batch(params, w, cfg)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        stats = prof.key_averages()
        # only the device's own events (kernels, copies): a CPU op's row
        # repeats the device time of the kernels it launched
        on_dev = [e for e in stats if e.device_type == DeviceType.CUDA]
        dev_us = lambda e: e.self_device_time_total
        busy_s = sum(dev_us(e) for e in on_dev) / 1e6
        kernels = sum(e.count for e in stats if "LaunchKernel" in e.key)
        check(busy_s > 0, f"profile[{name}]: the profiler saw no device time")
        check(busy_s <= wall_prof, f"profile[{name}]: device time {busy_s} s > wall {wall_prof} s")
        top = sorted(on_dev, key=dev_us, reverse=True)[:6]
        out[name] = dict(wall_s=wall, wall_profiled_s=wall_prof, device_busy_s=busy_s,
                         busy_share=busy_s / wall, kernel_launches=kernels,
                         top=[(e.key, dev_us(e) / 1e3, e.count) for e in top])
        print(f"profile[{name}] (cut depth): wall {wall:.3f} s ({wall_prof:.3f} s profiled), "
              f"device busy {busy_s:.4f} s = {100 * busy_s / wall:.2f}% of wall, "
              f"{kernels} kernel launches", flush=True)
        for key, ms, count in out[name]["top"]:
            print(f"  {ms:9.2f} ms  x{count:<7d} {key[:90]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, help="also write the full report as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one short solve per config (device busy share)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the port (src/repro_torch) is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fedsem_objective import kernel

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: build
    t0 = time.perf_counter()
    path, log = kernel.build()
    kernel.load()
    build_s = time.perf_counter() - t0
    print(f"build: {path.name} in {build_s:.2f} s", flush=True)
    for line in log.strip().splitlines():
        print(f"  ptxas: {line.strip()}")

    # phase 2: kernel vs plain version
    cases = phase_kernel(device)
    for c in cases:
        print(f"{c['entry']}{tuple(c['shape'])} feasible={c['check_feasible']}: device "
              f"kernel {c['ms']:.6f} ms, plain {c['plain_ms']:.6f} ms, bound "
              f"{c['bound_ms']:.6f} ms ({c['bound_by']}); per eager call: wrapper "
              f"{c['wrapper_ms']:.5f} ms, plain {c['plain_eager_ms']:.5f} ms; "
              f"max abs err {c['max_abs_err']:.3g}", flush=True)

    # phase 3: the slice
    solves, launches = phase_slice(device)
    profiled = phase_profile(device) if args.profile else None

    trace_case = next(c for c in cases if c["shape"] == [48, 1, 10] and not c["check_feasible"])
    record = {"kernels": [{
        "name": "fedsem_objective_batch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fedsem_objective/csrc/objective.cu",
        "replaces": "src/repro/kernels/fedsem_objective/kernel.py:171",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": trace_case["ms"],
        "plain_ms": trace_case["plain_ms"],
        "bound_ms": trace_case["bound_ms"],
        "bound_by": trace_case["bound_by"],
        "library_ms": None,
    }]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            dict(build_s=build_s, cases=cases, solves=solves, profile=profiled,
                 record=record, card=smi), indent=1))
    print(json.dumps(record))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
