#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FedSem on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json] [--profile]

Phases (any failure exits non-zero; nothing is skipped and nothing runs on
the CPU in place of the card):

1. build the CUDA kernels of `repro_torch.kernels` (`fedsem_objective`,
   `flash_attention`, `rwkv6_scan`, `mamba_scan`) from the sources in this
   checkout, one nvcc (sm_90a) each, all at once, and print ptxas' report;
   the flash library's bf16 kernel (one instantiation per head dim) must
   hold `HGMMA` (wgmma) instructions in its SASS (`cuobjdump -sass`); the
   WKV6 and selective-scan kernels' registers are printed, and no
   instantiation of either may spill;
2. hold the objective kernel against its plain PyTorch version on the card at the
   shapes the solver gives it ((B, G, N) = (16, 3, 10) for the multi-start
   selection, (48, 1, 10) for the per-iteration trace), at a large-G case
   (64, 8192, 8), at the exhaustive sweep's shapes with the feasibility mask
   ((1, 800000, 4), each of Table II's 1024 chunks; (64, 6912, 3), each of the
   oracle gate's 2), and `objective_grid` at (G, N) = (1024, 10); with
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

4. build check of the flash-attention kernel of
   `repro_torch.kernels.flash_attention` against its plain version (the
   chunked attention of `repro_torch.models.attention`) on the card: float32
   (the CUDA-core kernel) and bfloat16 (the tensor-core kernel); MHA, GQA,
   MQA; S not a block multiple; window; softcap; non-causal; hd 256; the
   Gemma-2 2B layer shapes (B = 1, S = 8192, H 8, KV 4, hd 256, bf16; global
   and window 4096, softcap 50), the Qwen2.5-3B shape (H 16, KV 2, hd 128)
   and the Jamba-1.5-Large attention layer (S = 4096, H 64, KV 8, hd 128,
   bf16). Tolerance, absolute plus relative: float32 the JAX tests' own
   2e-5; bfloat16 one bf16 ulp (rtol 2**-7, atol 1e-4): the plain version
   keeps the probabilities P in float32 for P V, and the bf16 kernel keeps
   them to about 2^-17 (P V = P_hi V + P_lo V, two bf16 products), so the
   two differ by the rounding of the output (the JAX tests' 2e-2 would be as
   large as the outputs of the late rows at S = 8192). Each case is timed
   on the device (CUDA-graph replay) beside its bound, with the plain
   version and one PyTorch call that computes the same function:
   `scaled_dot_product_attention` without a softcap, compiled
   `flex_attention` with the softcap as its score_mod; each bf16 case prints
   the share of the bound the kernel reaches and its factor against that
   call. The call is held to the JAX tests' tolerance; whether it also
   stays within the kernel's one-ulp gate is recorded, not required (it
   rounds P to bf16);
5. the LM slice: `gemma2_2b` at full width in bfloat16 on the card from a
   seeded `torch.Generator`; `prefill(use_kernel=True)` on B = 1, S = 8192
   tokens must launch the kernel once per layer (26) and give finite logits.
   The same prefill with the plain attention and the same model in float32
   (plain attention) are the yardsticks: the kernel's logits must lie no
   farther from the plain bf16 logits than the plain bf16 logits lie from
   the float32 ones (the bf16 rounding of the whole model). In float32,
   each layer's kernel route must match its plain route on the same input
   (the plain run's, layer by layer) at the kernels' float32 tolerance
   (atol and rtol 1e-4), and the kernel prefill's logits must lie no
   farther from the plain ones than twice the gap a one-ulp perturbation of
   the embedding table makes (the random-weight model amplifies rounding at
   its first positions, so a fixed logit tolerance would fail the plain
   version against itself). One more warm kernel prefill runs under
   `torch.profiler`: the kernel's device time and launches in the trace,
   the matrix products' device time and the device's busy time;
6. `ServeLoop` on the same model: 8 requests of 8 tokens, 4 slots, 16 new
   tokens each, max_len 256; every request must come back with 16 tokens
   in the vocabulary;
7. the WKV6 kernel of `repro_torch.kernels.rwkv6_scan` against its plain
   version (the step-by-step recurrence of its ``ref.py``) on the card: the
   reference's test shapes ((1, 2, 128, 64) and (2, 4, 96, 32), float32 and
   bfloat16), a ragged S, a strong decay (w = exp(-exp(1 + 0.5 z)), near
   0.07, at (2, 4, 1024, 64)), and the full-width RWKV-6 1.6B layer (B 1,
   S 4096, H 32, hd 64, w near the model's exp(-exp(-6))) all in float32
   and in the types the bf16 model hands over (bf16 r/k/v, float32 w and
   y); the strong-decay and model-law cases in the model's (B, S, H, hd)
   layout. Tolerance by y's type, absolute plus relative: float32 the JAX
   tests' 1e-4; bfloat16 one bf16 ulp of the output (rtol 2**-7, atol
   1e-5), since kernel and plain version evolve the same float32 state,
   rounded alike, and differ only in y's sum (the bonus term factored out
   and the sum over the key index in another order). The kernel is timed on
   the device (CUDA-graph replay) beside its bound (the function's float32
   operations: 5 per step, key and value column, an FMA counted as 2); the
   plain version by graph replay up to S = 1024 and by events around one
   eager call at S = 4096 (a graph of its 28,000 launches is not worth its
   capture). No single PyTorch call computes WKV6;
8. the RWKV slice: `rwkv6_1_6b` at full width in bfloat16 from a seeded
   `torch.Generator`; `prefill(use_kernel=True)` on B = 1, S = 4096 tokens
   must launch the WKV kernel once per layer (24) and give finite logits,
   with the yardsticks, logit gates and profile of phase 5;
9. `ServeLoop` on the RWKV model, as phase 6 (decode carries the state
   through the plain one-step recurrence and launches no kernel);
10. the selective-scan kernel of `repro_torch.kernels.mamba_scan` against its
   plain version (the step-by-step recurrence of its ``ref.py``) on the card:
   the reference's test cases ((B, S, di, N) = (1, 64, 128, 8) and
   (2, 96, 64, 16); x and dt float32 or bfloat16, B/C float32), a ragged S
   and di, B/C as strided column views of one projection, dt A down to
   about -100 (dt = softplus(z + 2): exp(dt A) underflows, and the kernel's
   exponential flushes what would be subnormal to 0), and the full-width
   Jamba-1.5-Large layer (1, 4096, 16384, 16) all in float32 and in the
   types the bf16 model hands over (bf16 x, float32 dt, bf16 B/C views; y
   in x's type), with dt and A of the initialised model's law. Tolerance
   by y's type: float32 the JAX tests' 1e-4; bfloat16 one bf16 ulp (rtol
   2**-7, atol 1e-5): kernel and plain version evolve a float32 state with
   every operation rounded alike but the exponential (2^(dt A log2 e) on
   the exponential unit, a few ulp from `expf`), and sum over the state in
   another order. Timed as
   phase 7, beside its bound (the bytes, or the operations: the
   exponentials shared between the card's exponential unit, 16 a clock per
   SM, and polynomials on the float32 pipe beside the other float32
   operations, in the share that levels the two; whichever takes longer). No
   single PyTorch call computes the selective scan;
11. the Jamba slice: `jamba_1_5_large_398b` at full width cut to one period
   with every FFN dense (``scaled(n_layers=8, n_experts=0, top_k=0)``: 7
   Mamba layers and 1 attention layer (H 64, KV 8, hd 128), 9.0 B
   parameters) in bfloat16 from a seeded `torch.Generator`;
   `prefill(use_kernel=True)` on B = 1, S = 4096 tokens must launch the
   selective-scan kernel once per Mamba layer (7) and the flash kernel once
   per attention layer (1) and give finite logits, with the yardsticks,
   logit gates and profile of phase 5;
12. `ServeLoop` on the Jamba cut, as phase 6 (decode carries (conv window,
   h) through the plain one-step recurrence and launches no kernel);
13. the scenario families and the paper's baselines: 16 Table-I scenarios
   (N = 10, K = 50) from seed 0 of each of the four families on the card
   (`iid_rayleigh` reuses phase 3's solve), `solve_batch` under
   ``AllocatorConfig(inner="pgd")``, and the four baselines of
   `repro_torch.core.baselines` on the same batch, one call each. Every leaf
   finite; Alg. A2's X and the equal, computation-only and random
   baselines' X binary with every subcarrier owned once (the
   communication-only baseline returns PGD's relaxed X: in [0, 1], each
   subcarrier owned at most once); Alg. A2 feasible on every scenario and
   no worse than every feasible baseline (+1e-3, like with like); the count
   of infeasible baselines is printed, with each family's solve time and
   `hetero_classes`' three device classes;
14. the exhaustive oracle (`repro_torch.core.exhaustive`) through the
   objective kernel: Table II on the card (`iid_rayleigh`, N 4, K 5, seed 0,
   f 5 levels in [0.25, 2] GHz, p 4 levels in [4, 20] dBm, rho 5 levels in
   [0.2, 1]: G = 800,000 candidates for each of the 1024 assignments), once
   with the kernel and once with ``use_kernel=False`` on the same card
   tensors. Both must return the same allocation (or, on a tie, values
   within phase 2's tolerance); the kernel launches once per chunk (1024)
   on the kernel run and never on the plain run; the value equals the
   port's `report` objective of its allocation to rtol 1e-5, and the
   allocation is feasible. Each run's wall time (ending in a synchronize)
   and candidates per second are printed, and one more warm kernel sweep
   runs under `torch.profiler` (the device's busy share, the kernel's
   device time); then Alg. A2's objective (PGD) on the same instance and
   Table II's claims (printed, not gated: the instance is the port's
   draw). Then the oracle gate's sweep (N 3, K 4,
   the gate's grids) for each family, kernel against plain, as above;
15. serving (`repro_torch.serve`) on the card at full width: an
   `iid_rayleigh` stream of 12 requests of sizes (10, 50) (Table I; bucket
   (16, 64)) and (6, 16) (bucket (8, 16)) at the Table-I bbar, Poisson
   arrivals at 20 req/s, `AllocService` with the serving config
   ``AllocatorConfig(inner="pgd")`` at default iteration counts,
   `DEFAULT_BUCKETS`, max_batch 8, max_wait 50 ms. Passes: (a) the
   `RealClockDriver` through `pace_stream`, then a drain; (b) the same
   stream and arrivals through `run_load` on the virtual clock; (c) the
   same stream again, all at once, through a ``warmstart=WarmStartConfig()``
   service whose cache holds (a)'s solutions, so every request hits; then
   the (6, 16) requests at cut depth (1 outer iteration, 100 PGD steps: a
   full-depth flush holds too many events for the profiler) in one kernel
   flush, the same under `torch.profiler`, and one flush of the plain
   scoring path (``use_kernel_objective=False``). Gates: every request
   answered once, binary and feasible at its exact shape,
   `Completion.objective` equal to `system.objective` there to rtol 1e-5;
   (a) and (b) give the same req_id -> X; in (c) every request hits and
   no objective exceeds (b)'s + 1e-5 max(1, |cold|); the kernel launches 8
   times per cold flush (6 trace entries, the multi-start selection, the
   flush's scoring) and 15 per flush with a hit (+ the refine pass's 7),
   never on the plain path, whose allocations equal its kernel twin's and
   whose objectives lie within phase 2's tolerance of them. Printed:
   latency p50/p99, throughput, `solve_s` per flush, each solver's first
   call, the warm hit rate and outer iterations to converge, the profiled
   flush's device busy share, and the kernel at each serving launch shape
   phase 2 does not time (graph replay, bound, plain version).

Each LM path launches, per prefill, each kernel as often as it has layers of
that kernel's kind (attention: flash; rwkv: WKV6; mamba: the selective scan)
and every other kernel never; the allocator paths (3, 13, 14 and 15)
launch the objective kernel and no other. Each path (3, 5 + 6, 8 + 9,
11 + 12, 13, 14 and 15) is driven with the kernels' launch counts set to 0
just before it and read just after. With ``--profile``, one short solve
per config (cut depth) also runs under `torch.profiler`, for the device's
busy share. The last lines are the kernels' JSON record, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.

Exit codes: 0 all phases passed; 1 a phase failed; 4 no CUDA card; 5 the
port (``src/repro_torch``) is not beside this script (2 is argparse's
usage error).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
#: phase 4's (atol, rtol) of the kernel against its plain version: float32 the
#: JAX tests' 2e-5 (tests/test_kernels.py), bfloat16 one ulp of the output
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-4, 2**-7)}
#: the library call against the plain version: the JAX tests' tolerance
LIBRARY_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: phase 7's and phase 10's (atol, rtol): float32 the JAX tests' 1e-4,
#: bfloat16 one ulp
WKV_TOL = SCAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2**-7)}
#: float32 operations WKV6 needs per (step, key, value column): the FMA of
#: r_i S_ij into y_j (2), k_i v_j, the FMA w_i S_ij + k_i v_j (2); and per
#: (step, key) the bonus term's r_i u_i k_i and its sum (3), per (step, value
#: column) v_j times that sum and its add into y_j (2)
WKV_OPS, WKV_OPS_KEY, WKV_OPS_COL = 5, 3, 2
#: float32 operations the selective scan needs per (step, channel, state):
#: dt A, da h, (dt x) B, their add, the FMA of h C into y (2); and per (step,
#: channel): dt x, D x and its add. Besides, one exponential per (step,
#: channel, state)
SCAN_OPS, SCAN_OPS_CHANNEL = 6, 3
#: exponentials a second: 16 a clock on each of the 132 SMs (the exponential
#: unit's rate in the CUDA programming guide's throughput table for compute
#: capability 9.0) at the 1.98 GHz that the float32 rate implies
#: (67e12 = 132 SMs x 128 lanes x 2 x 1.98e9)
EXP_PER_S = 16 * 132 * FP32_FLOPS_PER_S / (132 * 128 * 2)
#: float32 operations of an exponential computed as a polynomial on the FMA
#: pipe instead (as FlashAttention-3 does for part of its exponentials):
#: round the base-2 argument with a magic-number add, subtract it back, take
#: the fraction (3 adds), and a degree-5 Horner polynomial for 2^f on
#: [-1/2, 1/2] (5 FMAs: about 1 ulp, as `expf`'s 2); the exponent's insert is
#: integer work, off that pipe
EXP_POLY_OPS = 3 + 5 * 2
#: phases 5 and 8's float32 gates: each layer's kernel route against its
#: plain route on the same input at the kernels' float32 (atol, rtol) (the
#: JAX tests' 1e-4); and the kernel prefill's logits no farther from the
#: plain prefill's than this many times the gap a one-ulp perturbation of the
#: embedding table makes (the model's own float32 sensitivity)
LM_LAYER_TOL = (1e-4, 1e-4)
LM_F32_ULP_FACTOR = 2.0
#: the symbol of each LM kernel, as it appears in a profiler trace
KERNEL_SYMBOLS = {"flash_attention": "flash_fwd_kernel", "rwkv6_scan": "wkv6_fwd_kernel",
                  "mamba_scan": "mamba_scan_fwd_kernel"}
#: the main path's instantiation of the WKV6 kernel (bf16 r/k/v, float32 w
#: and y, hd 64) and of the selective scan (bf16 x and y, float32 dt, bf16
#: B/C, N 16), as they appear in the mangled names ptxas reports
MAIN_INSTANTIATION = {"rwkv6_scan": "wkv6_fwd_kernelI13__nv_bfloat16ffLi64E",
                      "mamba_scan": "mamba_scan_fwd_kernelI13__nv_bfloat16fS1_Li16E"}
#: every kernel of the port, by module name under `repro_torch.kernels`
KERNELS = ("fedsem_objective", "flash_attention", "rwkv6_scan", "mamba_scan")
#: the kernel a prefill launches once for each layer of a block kind
KERNEL_OF_KIND = {"attn": "flash_attention", "attn_local": "flash_attention",
                  "rwkv": "rwkv6_scan", "mamba": "mamba_scan"}
#: what marks a matrix product's kernel in a trace (cuBLAS and CUTLASS names)
PRODUCT_MARKS = ("gemm", "xmma", "nvjet", "cutlass")
#: the LM paths: (arch, prefill length, the cut of its config, as
#: `ModelConfig.scaled` arguments)
LM_PATHS = (("gemma2_2b", 8192, {}),                  # phases 5-6 (> the 4096 window)
            ("rwkv6_1_6b", 4096, {}),                 # phases 8-9 (RWKV-6's training context)
            # phases 11-12: one period, the MoE FFNs dense (ROADMAP item 12
            # ports the experts; one period with them is 90 GB in bf16)
            ("jamba_1_5_large_398b", 4096, dict(n_layers=8, n_experts=0, top_k=0)))
#: the exit codes for no card and for no port beside the script
EXIT_NO_CARD, EXIT_NO_PORT = 4, 5
RTOL, ATOL = 5e-7, 1e-5
XI, ETA, AB = 1e-28, 10, (0.6356, 0.4025)
#: the exhaustive sweep's launches of the objective kernel, (B, G, N) with
#: the feasibility mask: Table II's full levels (1024 chunks of one
#: assignment) and the per-family oracle gate (2 chunks of 64)
SWEEP_SHAPES = ((1, 800000, 4), (64, 6912, 3))
#: phase 13's scenarios per family (Table I: N 10, K 50)
FAMILY_B = 16
#: phase 14's Table II grid (benchmarks/table2_exhaustive.py, full levels)
TABLE2_LEVELS = dict(f_levels=(0.25e9, 2e9, 5), p_levels_dbm=(4.0, 20.0, 4), rho_levels=(0.2, 1.0, 5))
#: floating-point operations per (candidate, device) of eq. 13 as the kernel
#: evaluates it (divisions, products, sums, compares; exp/log counted once)
OPS_PER_ELEMENT = 24
#: phase 15's stream: Table I's (10, 50) (bucket (16, 64)) and (6, 16)
#: (bucket (8, 16)) at the Table-I bbar, Poisson arrivals at the serving
#: CLI's default rate, its default batching policy
SERVE_SIZES = ((10, 50), (6, 16))
SERVE_REQUESTS = 12
SERVE_RATE_HZ = 20.0
SERVE_MAX_BATCH, SERVE_MAX_WAIT_S = 8, 0.05
#: the real-clock driver's drain bound (a flush takes about 20 s)
SERVE_TIMEOUT_S = 900.0


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


def flash_tensor_core_sass(lib_path) -> dict:
    """Phase 1's proof that the bf16 flash kernel runs on the tensor cores:
    the `HGMMA` (wgmma) instructions in the SASS (``cuobjdump -sass``) of
    each instantiation of its `flash_fwd_kernel_sm90`. Returns {hd: count}."""
    from repro_torch.kernels.build import nvcc
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    tool = pathlib.Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, hd = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"flash_fwd_kernel_sm90ILi(\d+)E", line)
            hd = int(found.group(1)) if found else None
            if hd is not None:
                counts[hd] = 0
        elif hd is not None and "HGMMA" in line:
            counts[hd] += 1
    check(sorted(counts) == sorted(HEAD_DIMS) and all(counts.values()),
          f"flash: the bf16 kernel's SASS lacks HGMMA at some head dim: {counts}")
    return counts


def ptxas_report(log: str) -> dict:
    """Per kernel function of a ptxas ``-v`` log: {mangled name: dict(
    registers, spill_bytes (stores + loads), stack_bytes)}."""
    out, fn = {}, None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?$", line.strip())
        if found:
            fn = found.group(1)
            out.setdefault(fn, dict(registers=None, spill_bytes=0, stack_bytes=0))
            continue
        if fn is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[fn]["stack_bytes"] = int(spill.group(1))
            out[fn]["spill_bytes"] = int(spill.group(2)) + int(spill.group(3))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[fn]["registers"] = int(regs.group(1))
    return out


def phase_kernel(device):
    """Phase 2: kernel vs plain version, timed. Returns per-case records."""
    import torch

    from repro_torch.kernels.fedsem_objective import kernel, ref

    gen = torch.Generator(device=device).manual_seed(1234)
    cases = []
    ab = tuple(torch.tensor(v, device=device) for v in AB)
    for B, G, N in ((16, 3, 10), (48, 1, 10), (64, 8192, 8)) + SWEEP_SHAPES:
        args, mask, kap = grid_inputs(gen, B, G, N, device)
        for feas in (True,) if (B, G, N) in SWEEP_SHAPES else (True, False):
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


def check_binary_x(params, X, what: str) -> None:
    check(bool(((X == 0) | (X == 1)).all()), f"{what}: X is not binary")
    check(bool((X.sum(dim=-2) == params.sc_mask).all()), f"{what}: a subcarrier not owned exactly once")


def check_allocation(params, res, what: str) -> None:
    import torch

    from repro_torch.core.system import feasible

    a = res.alloc
    for name in ("f", "P", "X", "rho"):
        check(bool(torch.isfinite(getattr(a, name)).all()), f"{what}: non-finite {name}")
    check(bool(torch.isfinite(res.trace).all()), f"{what}: non-finite trace")
    check_binary_x(params, a.X, what)
    check(bool((a.X.sum(dim=-1) >= 1).all()), f"{what}: a device owns no subcarrier")
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
    zero_launches()                          # the allocator path starts here
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
    main_path_launches = only_objective_launched("the allocator path")    # ... and ends here

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
        main_path_launches, (params, solves["pgd"]["res"])


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


def attention_pairs(S: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one (batch, head): the work the
    attention needs on these inputs."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window is not None else 0
        hi = q + 1 if causal else S
        total += hi - lo
    return total


def flash_bound(B, S, H, KV, hd, dtype, causal, window):
    """(ms, 'bytes'|'operations'): 4 * hd operations per unmasked pair and
    head over the peak of the input type (bf16 tensor cores; float32 outside
    them), against q, k, v read once and the output written once."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    flops = 4 * hd * B * H * attention_pairs(S, causal, window)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: phase 4's cases: (name, (B, S, H, KV, hd), dtype, causal, window, cap)
FLASH_CASES = [
    *((f"mha {dt}", (1, 128, 4, 4, 64), dt, True, None, None) for dt in ("float32", "bfloat16")),
    *((f"gqa {dt}", (2, 256, 4, 2, 64), dt, True, None, None) for dt in ("float32", "bfloat16")),
    *((f"mqa {dt}", (1, 256, 8, 1, 32), dt, True, None, None) for dt in ("float32", "bfloat16")),
    *((f"ragged S {dt}", (1, 192, 2, 2, 128), dt, True, None, None) for dt in ("float32", "bfloat16")),
    ("window", (2, 256, 4, 2, 64), "float32", True, 64, None),
    ("softcap", (2, 256, 4, 2, 64), "float32", True, None, 50.0),
    ("non-causal", (2, 256, 4, 2, 64), "float32", False, None, None),
    ("hd 256 window softcap", (1, 160, 2, 1, 256), "float32", True, 64, 50.0),
    ("gemma2_2b global", (1, 8192, 8, 4, 256), "bfloat16", True, None, 50.0),
    ("gemma2_2b local", (1, 8192, 8, 4, 256), "bfloat16", True, 4096, 50.0),
    ("qwen2_5_3b", (1, 8192, 16, 2, 128), "bfloat16", True, None, None),
    ("jamba_1_5_large_398b attn", (1, 4096, 64, 8, 128), "bfloat16", True, None, None),
]


def library_call(q, k, v, causal, window, cap, compiled_flex):
    """One PyTorch call that computes the same attention, over the (B, heads,
    S, hd) views with GQA on: `scaled_dot_product_attention` with the
    causal/window mask, or, with a softcap, `flex_attention` (compiled) with
    cap * tanh(s / cap) as its score_mod and the mask as its block mask."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import create_block_mask

    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if cap is not None:
        def keep(b, h, qi, ki):
            m = (ki <= qi) if causal else (ki >= 0)
            return m & (qi - ki < window) if window is not None else m

        blocks = create_block_mask(keep, None, None, S, S, device=q.device)
        score = lambda s, b, h, qi, ki: cap * torch.tanh(s / cap)
        return lambda: compiled_flex(qt, kt, vt, score_mod=score, block_mask=blocks,
                                     enable_gqa=True).transpose(1, 2)
    mask = None
    if window is not None:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] - pos[None, :] < window
        if causal:
            mask &= pos[None, :] <= pos[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True,
    ).transpose(1, 2)


def phase_flash(device):
    """Phase 4: the flash kernel against its plain version, timed."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.attention import flash_attention as plain_flash

    compiled_flex = torch.compile(flex_attention, dynamic=False)
    gen = torch.Generator(device=device).manual_seed(4321)
    cases = []
    for name, (B, S, H, KV, hd), dt, causal, window, cap in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=device).to(dtype)
                   for n in (H, KV, KV))
        pos = torch.arange(S, dtype=torch.int32, device=device)
        run_k = lambda: kernel.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
        run_p = lambda: plain_flash(q, k, v, q_positions=pos, kv_positions=pos,
                                    causal=causal, window=window, cap=cap)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[dt]
        check(bool(torch.isfinite(got.float()).all()), f"flash[{name}]: non-finite output")
        check(got.dtype == dtype and got.shape == want.shape, f"flash[{name}]: dtype or shape")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"flash[{name}]: max abs err {float(err.max())} beyond atol {atol} + rtol {rtol}")
        run_l = library_call(q, k, v, causal, window, cap, compiled_flex)
        library = "flex_attention" if cap is not None else "scaled_dot_product_attention"
        lib_err = (run_l().float() - want.float()).abs()
        tol = LIBRARY_TOL[dt]
        check(bool((lib_err <= tol + tol * want.float().abs()).all()),
              f"flash[{name}]: {library} differs from the plain version by {float(lib_err.max())}")
        # the library call against the kernel's own gate: recorded, not required
        lib_gate = float((lib_err / (atol + rtol * want.float().abs())).max())
        big = S >= 4096
        reps, iters = (2, 3) if big else (20, 20)
        rec = dict(case=name, shape=[B, S, H, KV, hd], dtype=dt, causal=causal, window=window,
                   cap=cap, atol=atol, rtol=rtol, max_abs_err=float(err.max()),
                   out_mean_abs=float(want.float().abs().mean()),
                   out_mean_abs_last_row=float(want[:, -1].float().abs().mean()),
                   ms=graph_ms(run_k, reps, iters), plain_ms=graph_ms(run_p, reps, iters),
                   library=library, library_ms=graph_ms(run_l, reps, iters),
                   library_max_abs_err=float(lib_err.max()), library_gate_ratio=lib_gate)
        rec["bound_ms"], rec["bound_by"] = flash_bound(B, S, H, KV, hd, dtype, causal, window)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["library_factor"] = rec["ms"] / rec["library_ms"]
        cases.append(rec)
        print(f"flash[{name}] {tuple(rec['shape'])} {dt}: kernel {rec['ms']:.5f} ms, plain "
              f"{rec['plain_ms']:.5f} ms, {library} {rec['library_ms']:.5f} ms, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); max abs err "
              f"{rec['max_abs_err']:.3g} (mean |out| {rec['out_mean_abs']:.3g}, last row "
              f"{rec['out_mean_abs_last_row']:.3g}; {library} {rec['library_max_abs_err']:.3g})",
              flush=True)
        if dtype == torch.bfloat16:
            print(f"flash[{name}] bf16: {100 * rec['bound_share']:.2f}% of the bound, "
                  f"{rec['library_factor']:.3f}x {library}; {library} "
                  f"{'within' if lib_gate <= 1.0 else 'outside'} the one-ulp gate "
                  f"({lib_gate:.3g} of it)", flush=True)
    torch.cuda.synchronize()
    return cases


def wkv_bound(B, H, S, hd, dtype, w_dtype, out_dtype):
    """(ms, 'bytes'|'operations'): the float32 operations the function needs
    over the float32 peak, against r, k, v (``dtype``) and w read once, y
    written once and u (float32) read once. The function needs y_j =
    sum_i r_i S_ij + v_j sum_i r_i u_i k_i, the bonus term factored out of
    the (key, column) loop, as the kernel evaluates it."""
    import torch

    size = lambda dt: torch.tensor([], dtype=dt).element_size()
    nbytes = B * H * S * hd * (3 * size(dtype) + size(w_dtype) + size(out_dtype)) + 4 * H * hd
    flops = B * H * S * (WKV_OPS * hd * hd + (WKV_OPS_KEY + WKV_OPS_COL) * hd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: phase 7's cases: (name, (B, H, S, hd), type of r/k/v, of w, of y, the law
#: of w: the reference test's sigmoid law, the model's exp(-exp(-6 + 0.5 z))
#: (near 0.9975) or a strong decay exp(-exp(1 + 0.5 z)) (near 0.07)); the
#: model's and the strong law in the model's (B, S, H, hd) layout. The
#: full-width cases: all float32, and the types the bf16 model hands over
#: (the main path's)
WKV_CASES = [
    *((f"reference (1, 2, 128, 64) {dt}", (1, 2, 128, 64), dt, dt, dt, "reference")
      for dt in ("float32", "bfloat16")),
    *((f"reference (2, 4, 96, 32) {dt}", (2, 4, 96, 32), dt, dt, dt, "reference")
      for dt in ("float32", "bfloat16")),
    *((f"ragged S {dt}", (2, 3, 77, 64), dt, dt, dt, "reference") for dt in ("float32", "bfloat16")),
    ("strong decay", (2, 4, 1024, 64), "bfloat16", "float32", "float32", "strong"),
    ("rwkv6_1_6b layer float32", (1, 32, 4096, 64), "float32", "float32", "float32", "model"),
    ("rwkv6_1_6b layer", (1, 32, 4096, 64), "bfloat16", "float32", "float32", "model"),
]
#: the (mean, scale) of the normal z in w = exp(-exp(mean + scale z)) by law
WKV_DECAY_LAWS = {"model": (-6.0, 0.5), "strong": (1.0, 0.5)}
#: the phase-7 case at the shape and types the RWKV prefill launches the kernel with
WKV_MAIN = "rwkv6_1_6b layer"


def phase_wkv(device):
    """Phase 7: the WKV6 kernel against its plain version, timed."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel, ref

    gen = torch.Generator(device=device).manual_seed(2468)
    cases = []
    for name, (B, H, S, hd), dt, dt_w, dt_y, law in WKV_CASES:
        dtype, w_dtype, out_dtype = (getattr(torch, t) for t in (dt, dt_w, dt_y))
        # (B, S, H, hd) tensors seen as (B, H, S, hd) views, as the model hands them over
        draw = lambda: torch.randn((B, S, H, hd), generator=gen, device=device).transpose(1, 2)
        r, k, v = draw(), draw(), draw()
        if law in WKV_DECAY_LAWS:
            mean, scale = WKV_DECAY_LAWS[law]
            w = torch.exp(-torch.exp(mean + scale * draw()))
        else:   # the reference test's law
            w = torch.sigmoid(draw()) * 0.5 + 0.45
        u = torch.randn((H, hd), generator=gen, device=device)
        r, k, v, u = (x.to(dtype) for x in (r, k, v, u))
        w = w.to(w_dtype)
        run_k = lambda: kernel.rwkv6_scan(r, k, v, w, u, out_dtype)
        run_p = lambda: ref.rwkv6_scan(r, k, v, w, u, out_dtype=out_dtype)[0]
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        atol, rtol = WKV_TOL[dt_y]
        check(bool(torch.isfinite(got.float()).all()), f"wkv[{name}]: non-finite output")
        check(got.dtype == out_dtype and got.shape == want.shape, f"wkv[{name}]: dtype or shape")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"wkv[{name}]: max abs err {float(err.max())} beyond atol {atol} + rtol {rtol}")
        rec = dict(case=name, shape=[B, H, S, hd], dtype=dt, w_dtype=dt_w, out_dtype=dt_y,
                   atol=atol, rtol=rtol,
                   max_abs_err=float(err.max()), out_mean_abs=float(want.float().abs().mean()),
                   w_mean=float(w.float().mean()), ms=graph_ms(run_k))
        if S <= 1024:
            rec["plain_ms"], rec["plain_timing"] = graph_ms(run_p, 1, 5), "graph replay"
        else:
            rec["plain_ms"], rec["plain_timing"] = cuda_ms(run_p, 1), "events around one eager call"
        rec["bound_ms"], rec["bound_by"] = wkv_bound(B, H, S, hd, dtype, w_dtype, out_dtype)
        cases.append(rec)
        print(f"wkv[{name}] {tuple(rec['shape'])} r/k/v {dt}, w {dt_w}, y {dt_y}: kernel {rec['ms']:.5f} ms, plain "
              f"{rec['plain_ms']:.5f} ms ({rec['plain_timing']}), bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}); max abs err {rec['max_abs_err']:.3g} (mean |y| "
              f"{rec['out_mean_abs']:.3g}, mean w {rec['w_mean']:.5f})", flush=True)
    torch.cuda.synchronize()
    return cases


def scan_bound(B, S, di, N, x_dtype, dt_dtype, b_dtype):
    """(ms, 'bytes'|'operations', parts): the least time of the selective
    scan. Operations: one exponential per (step, channel, state) and the
    float32 operations of `SCAN_OPS`/`SCAN_OPS_CHANNEL` at the float32 peak.
    Each exponential runs either on the exponential unit (`EXP_PER_S`) or as
    a polynomial of `EXP_POLY_OPS` on the float32 pipe beside the other
    float32 work; the bound takes the share of polynomials that levels the
    two. Bytes: x, dt, B, C read once, y (x's type) written once, A and D
    (float32) read once. ``parts``: the exponentials all on their unit, the
    float32 work alone, the bytes (ms each) and the polynomial share."""
    import torch

    size = lambda dt: torch.tensor([], dtype=dt).element_size()
    nbytes = (B * S * di * (2 * size(x_dtype) + size(dt_dtype))
              + 2 * B * S * N * size(b_dtype) + 4 * di * (N + 1))
    t_exp = B * S * di * N / EXP_PER_S * 1e3
    t_flops = B * S * di * (SCAN_OPS * N + SCAN_OPS_CHANNEL) / FP32_FLOPS_PER_S * 1e3
    t_poly = B * S * di * N * EXP_POLY_OPS / FP32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # a share f of polynomials: the unit takes (1 - f) t_exp, the pipe t_flops + f t_poly
    share = max(0.0, (t_exp - t_flops) / (t_exp + t_poly))
    t_ops = max((1 - share) * t_exp, t_flops + share * t_poly)
    kind = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), kind, dict(bound_exp_ms=t_exp, bound_fp32_ms=t_flops,
                                           bound_bytes_ms=t_bytes, bound_poly_share=share)


#: phase 10's cases: (name, (B, S, di, N), type of x (and y), of dt, of B/C,
#: the law: the reference test's, the model's (dt = softplus(-4.6 + 0.5 z),
#: near softplus(log(expm1(0.01))); A = -(1..N); B/C as column views of one
#: projection) or a deep one (the model's with dt = softplus(z + 2), so that
#: dt A reaches about -100, where exp(dt A) underflows))
SCAN_CASES = [
    *((f"reference (1, 64, 128, 8) {dt}", (1, 64, 128, 8), dt, dt, "float32", "reference")
      for dt in ("float32", "bfloat16")),
    *((f"reference (2, 96, 64, 16) {dt}", (2, 96, 64, 16), dt, dt, "float32", "reference")
      for dt in ("float32", "bfloat16")),
    *((f"ragged S and di {dt}", (2, 77, 96, 16), dt, dt, "float32", "reference")
      for dt in ("float32", "bfloat16")),
    ("strided B/C", (2, 512, 1024, 16), "bfloat16", "float32", "bfloat16", "model"),
    ("dt A to -100", (1, 1024, 1024, 16), "bfloat16", "float32", "bfloat16", "deep"),
    ("jamba_1_5_large_398b layer float32", (1, 4096, 16384, 16), "float32", "float32", "float32",
     "model"),
    ("jamba_1_5_large_398b layer", (1, 4096, 16384, 16), "bfloat16", "float32", "bfloat16",
     "model"),
]
#: the phase-10 case at the shape and types the Jamba prefill launches the kernel with
SCAN_MAIN = "jamba_1_5_large_398b layer"
#: the width of Jamba's x_proj output: dt rank 512 + 2 N
SCAN_PROJ_EXTRA = 512


def phase_scan(device):
    """Phase 10: the selective-scan kernel against its plain version, timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.mamba_scan import kernel, ref

    gen = torch.Generator(device=device).manual_seed(1357)
    draw = lambda *shape: torch.randn(shape, generator=gen, device=device)
    cases = []
    for name, (B, S, di, N), tx, td, tb, law in SCAN_CASES:
        x_dtype, dt_dtype, b_dtype = (getattr(torch, t) for t in (tx, td, tb))
        x = draw(B, S, di).to(x_dtype)
        if law != "reference":   # as the initialised Jamba has them; B and C views of x_proj's output
            z = draw(B, S, di)
            dt = F.softplus(z + 2.0 if law == "deep" else -4.6 + 0.5 * z)
            A = -torch.arange(1, N + 1, dtype=torch.float32, device=device).repeat(di, 1)
            proj = draw(B, S, SCAN_PROJ_EXTRA + 2 * N).to(b_dtype)
            Bm, Cm = proj[..., SCAN_PROJ_EXTRA:SCAN_PROJ_EXTRA + N], proj[..., SCAN_PROJ_EXTRA + N:]
        else:           # the reference test's law
            dt = F.softplus(draw(B, S, di)) * 0.1
            A = -draw(di, N).abs()
            Bm, Cm = draw(B, S, N).to(b_dtype), draw(B, S, N).to(b_dtype)
        dt = dt.to(dt_dtype)
        D = 1.0 + 0.5 * draw(di)
        run_k = lambda: kernel.mamba_scan(x, dt, Bm, Cm, A, D)
        run_p = lambda: ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        atol, rtol = SCAN_TOL[tx]
        check(bool(torch.isfinite(got.float()).all()), f"scan[{name}]: non-finite output")
        check(got.dtype == x_dtype and got.shape == want.shape, f"scan[{name}]: dtype or shape")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"scan[{name}]: max abs err {float(err.max())} beyond atol {atol} + rtol {rtol}")
        rec = dict(case=name, shape=[B, S, di, N], x_dtype=tx, dt_dtype=td, b_dtype=tb,
                   strided_bc=not Bm.is_contiguous(), atol=atol, rtol=rtol,
                   max_abs_err=float(err.max()), out_mean_abs=float(want.float().abs().mean()),
                   dt_mean=float(dt.float().mean()),
                   min_dt_a=float((dt.float().amax() * A.amin()).cpu()), ms=graph_ms(run_k))
        del got, want, err
        if S <= 1024:
            rec["plain_ms"], rec["plain_timing"] = graph_ms(run_p, 1, 5), "graph replay"
        else:
            rec["plain_ms"], rec["plain_timing"] = cuda_ms(run_p, 1), "events around one eager call"
        rec["bound_ms"], rec["bound_by"], parts = scan_bound(B, S, di, N, x_dtype, dt_dtype, b_dtype)
        rec.update(parts)
        cases.append(rec)
        print(f"scan[{name}] {tuple(rec['shape'])} x {tx}, dt {td}, B/C {tb}"
              f"{' (strided)' if rec['strided_bc'] else ''}: kernel {rec['ms']:.5f} ms, "
              f"plain {rec['plain_ms']:.5f} ms ({rec['plain_timing']}), bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}, {rec['bound_poly_share']:.3f} of the exponentials as "
              f"polynomials; all on the exponential unit {rec['bound_exp_ms']:.5f}, float32 "
              f"{rec['bound_fp32_ms']:.5f}, bytes {rec['bound_bytes_ms']:.5f}); max abs err "
              f"{rec['max_abs_err']:.3g} (mean |y| {rec['out_mean_abs']:.3g}, mean dt "
              f"{rec['dt_mean']:.5f}, dt A down to {rec['min_dt_a']:.1f})", flush=True)
    torch.cuda.synchronize()
    return cases


def profile_prefill(M, params, cfg, tokens, want):
    """One warm kernel prefill under `torch.profiler`: each of its kernels'
    device time and launches (``want``: the launches each kernel must show),
    the matrix products' device time, the device's busy time (its own events
    only, as in `phase_profile`) and the top entries."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = M.prefill(params, cfg, {"tokens": tokens}, use_kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out
    on_dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
    products = [e for e in on_dev if any(m in e.key.lower() for m in PRODUCT_MARKS)]
    busy = dev_ms(on_dev)
    check(busy > 0, f"profile[{cfg.name}]: the profiler saw no device time")
    kernel_ms, kernel_launches = {}, {}
    for name, n in want.items():
        mine = [e for e in on_dev if KERNEL_SYMBOLS[name] in e.key]
        count = sum(e.count for e in mine)
        check(count == n, f"profile[{cfg.name}]: the trace holds {count} {name} launches, want {n}")
        kernel_ms[name], kernel_launches[name] = dev_ms(mine), count
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return dict(wall_profiled_s=wall, device_busy_ms=busy, kernel_device_ms=kernel_ms,
                kernel_launches=kernel_launches, products_device_ms=dev_ms(products),
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])


def layer_by_layer(M, params, cfg, tokens, rows):
    """The plain prefill run one layer at a time, each layer also through its
    kernel route on the same input (the model's own layer functions). Returns
    (plain logits at ``rows``, per layer (max |kernel - plain|, the largest
    ratio of that gap to atol + rtol |plain|))."""
    atol, rtol = LM_LAYER_TOL
    x, positions = M._embed(params, cfg, {"tokens": tokens})
    gaps = []
    for blk in params.layers:
        want = M._apply_block(blk, cfg, x, positions, False)
        got = M._apply_block(blk, cfg, x, positions, True)
        err = (got - want).abs()
        gaps.append((float(err.max()), float((err / (atol + rtol * want.abs())).max())))
        del got, err
        x = want
    return M._head(params, cfg, x[:, rows])[0].float(), gaps


def perturb_one_ulp(params, seed):
    """Move every entry of the embedding table one ulp up or down at random."""
    import torch

    e = params.embed
    gen = torch.Generator(device=e.device).manual_seed(seed)
    up = torch.rand(e.shape, generator=gen, device=e.device) < 0.5
    inf = torch.tensor(float("inf"), dtype=e.dtype, device=e.device)
    with torch.no_grad():
        e.copy_(torch.nextafter(e, torch.where(up, inf, -inf)))


def phase_lm(device, arch, S, cut):
    """Full-width ``arch`` (cut by ``cut``, `ModelConfig.scaled` arguments)
    prefill of S tokens through its kernels (one launch per layer of each
    kernel's block kind) and `ServeLoop` on the same model (phases 5-6, 8-9
    and 11-12). Returns (report, each kernel's launches on the path)."""
    import importlib

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M

    kernels = {name: importlib.import_module(f"repro_torch.kernels.{name}.kernel")
               for name in KERNELS}
    cfg = get_config(arch).scaled(**cut)
    check(cfg.dtype == "bfloat16", f"{arch} is not a bf16 config")
    kinds = M.layer_kinds(cfg)
    want = {name: sum(KERNEL_OF_KIND[k] == name for k in kinds) for name in KERNELS}
    mine = [name for name, n in want.items() if n]        # the path's kernels
    seed = 0
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    init_s = time.perf_counter() - t0
    print(f"{arch}: {n_params / 1e9:.4f} B parameters in bf16 on the card "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated), init {init_s:.2f} s", flush=True)
    data = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=data, device=device)
    prompts = torch.randint(0, cfg.vocab, (8, 8), generator=data, device=device).tolist()

    for k in kernels.values():                            # the path starts here
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_k = M.prefill(params, cfg, {"tokens": tokens}, use_kernel=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {name: k.launches for name, k in kernels.items()}
    loop = ServeLoop(cfg, params, batch_slots=4, max_len=256)
    t0 = time.perf_counter()
    results, stats = loop.run(prompts, max_new=16)
    serve_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}   # ... and ends here
    check(prefill_launches == want,
          f"{arch} prefill launched the kernels {prefill_launches} times, want {want}")
    check(launches == prefill_launches, f"{arch} ServeLoop launched a kernel: {launches}")
    check(tuple(logits_k.shape) == (1, S, cfg.vocab), f"prefill logits shape {tuple(logits_k.shape)}")
    check(bool(torch.isfinite(logits_k).all()), "prefill logits are not finite")
    check(sorted(results) == list(range(8)), f"ServeLoop finished requests {sorted(results)}")
    for i, toks in results.items():
        check(len(toks) == 16 and all(0 <= t < cfg.vocab for t in toks),
              f"ServeLoop request {i}: {len(toks)} tokens, want 16 in [0, {cfg.vocab})")
    ms_step = 1e3 * sum(stats["step_times"]) / stats["steps"]
    counts = ", ".join(f"{want[name]} {name}" for name in mine)
    print(f"{arch} prefill(use_kernel=True) B=1 S={S}: {prefill_s:.3f} s wall (first call), "
          f"launches: {counts}; finite logits", flush=True)
    print(f"{arch} ServeLoop 8 requests x 16 tokens, 4 slots: {stats['steps']} steps in "
          f"{serve_s:.3f} s, {ms_step:.2f} ms/step", flush=True)

    # the yardsticks: the plain kernels' versions in bf16, and the same model in float32
    rows = torch.cat([torch.arange(0, S, 64, device=device), torch.tensor([S - 1], device=device)])
    timed = {}

    def run(p, c, use_kernel, name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = M.prefill(p, c, {"tokens": tokens}, use_kernel=use_kernel)
        torch.cuda.synchronize()
        timed[name] = time.perf_counter() - t
        sub = out[0, rows].float().clone()
        del out
        return sub

    sub_k = logits_k[0, rows].float().clone()
    del logits_k
    run(params, cfg, True, "kernel_s")                    # a second, warm call
    prof = profile_prefill(M, params, cfg, tokens, {name: want[name] for name in KERNEL_SYMBOLS})
    warm_ms = 1e3 * timed["kernel_s"]
    busy = prof["device_busy_ms"]
    shares = "; ".join(
        f"{prof['kernel_launches'][name]} {name} launches {prof['kernel_device_ms'][name]:.3f} ms = "
        f"{100 * prof['kernel_device_ms'][name] / warm_ms:.2f}% of the wall, "
        f"{100 * prof['kernel_device_ms'][name] / busy:.2f}% of busy" for name in mine)
    print(f"{arch} warm prefill, profiled ({prof['wall_profiled_s']:.3f} s wall): device busy "
          f"{busy:.2f} ms = {100 * busy / warm_ms:.2f}% of the unprofiled {warm_ms:.2f} ms; "
          f"{shares}; matrix products {prof['products_device_ms']:.3f} ms = "
          f"{100 * prof['products_device_ms'] / busy:.2f}% of busy", flush=True)
    for key, ms, count in prof["top"]:
        print(f"  {ms:9.3f} ms  x{count:<6d} {key[:100]}")
    sub_p = run(params, cfg, False, "plain_s")
    del params, loop
    torch.cuda.empty_cache()
    cfg32 = cfg.scaled(dtype="float32")
    params32 = M.init_params(cfg32, torch.Generator(device=device).manual_seed(seed))
    sub_fk = run(params32, cfg32, True, "float32_kernel_s")
    t0 = time.perf_counter()
    sub_f, layer_gaps = layer_by_layer(M, params32, cfg32, tokens, rows)
    torch.cuda.synchronize()
    timed["float32_layer_by_layer_s"] = time.perf_counter() - t0
    perturb_one_ulp(params32, seed + 2)
    sub_fq = run(params32, cfg32, False, "float32_ulp_plain_s")
    del params32
    torch.cuda.empty_cache()
    gap = lambda a, b: float((a - b).abs().max())
    worst_row = lambda a, b: int(rows[int((a - b).abs().amax(-1).argmax())])
    gap_kp, gap_pf, gap_kf = gap(sub_k, sub_p), gap(sub_p, sub_f), gap(sub_k, sub_f)
    gap_f32, gap_ulp = gap(sub_fk, sub_f), gap(sub_fq, sub_f)
    layer_err = max(g[0] for g in layer_gaps)
    layer_ratio = max(g[1] for g in layer_gaps)
    print(f"{arch} prefill logits at {rows.numel()} positions (|logit| <= "
          f"{float(sub_f.abs().max()):.3f}): kernel vs plain bf16 {gap_kp:.5g} (position "
          f"{worst_row(sub_k, sub_p)}), plain bf16 vs float32 {gap_pf:.5g} (position "
          f"{worst_row(sub_p, sub_f)}), kernel vs float32 {gap_kf:.5g}; in float32: kernel vs "
          f"plain {gap_f32:.5g} (position {worst_row(sub_fk, sub_f)}), one-ulp embedding vs "
          f"plain {gap_ulp:.5g} (position {worst_row(sub_fq, sub_f)}); each layer's kernel route "
          f"on the plain input: max abs err {layer_err:.3g}, at most {layer_ratio:.3g} of atol "
          f"{LM_LAYER_TOL[0]} + rtol {LM_LAYER_TOL[1]}; wall: kernel {timed['kernel_s']:.3f} s, "
          f"plain {timed['plain_s']:.3f} s, float32 kernel {timed['float32_kernel_s']:.3f} s, "
          f"float32 layer by layer {timed['float32_layer_by_layer_s']:.3f} s, float32 plain "
          f"{timed['float32_ulp_plain_s']:.3f} s", flush=True)
    check(gap_kp <= gap_pf,
          f"{arch}: kernel prefill differs from the plain one by {gap_kp}, more than bf16 rounding ({gap_pf})")
    check(layer_ratio <= 1.0,
          f"{arch}: a float32 layer's kernel route differs from its plain route by {layer_err} "
          f"({layer_ratio} of the tolerance)")
    check(gap_f32 <= LM_F32_ULP_FACTOR * gap_ulp,
          f"{arch}: float32 kernel prefill differs from the plain one by {gap_f32}, more than "
          f"{LM_F32_ULP_FACTOR} x a one-ulp embedding perturbation's {gap_ulp}")
    report = dict(arch=arch, cut=cut, tokens=S, params=n_params, init_s=init_s,
                  prefill_first_s=prefill_s, **timed, prefill_launches=prefill_launches, profile=prof,
                  kernel_share_of_warm_prefill={name: prof["kernel_device_ms"][name] / warm_ms
                                                for name in mine},
                  gap_kernel_plain=gap_kp, gap_plain_float32=gap_pf, gap_kernel_float32=gap_kf,
                  gap_float32_kernel_plain=gap_f32, gap_float32_one_ulp=gap_ulp,
                  layer_gaps=layer_gaps,
                  serve_steps=stats["steps"], serve_s=serve_s, serve_ms_per_step=ms_step)
    return report, launches


def zero_launches():
    """Set every kernel's launch count to 0 (the start of a path)."""
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel

    kernel.launches = flash_kernel.launches = wkv_kernel.launches = scan_kernel.launches = 0


def only_objective_launched(what: str) -> int:
    """The end of an allocator path: its objective-kernel launches; no LM
    kernel may have launched."""
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel

    check(flash_kernel.launches == wkv_kernel.launches == scan_kernel.launches == 0,
          f"{what} launched the flash, the WKV or the selective-scan kernel")
    return kernel.launches


def phase_families(device, iid_pgd):
    """Phase 13: each scenario family's Table-I batch through Alg. A2 (PGD)
    and the four baselines. ``iid_pgd`` is phase 3's (params, result) on the
    same ``iid_rayleigh`` draw."""
    import torch

    from repro_torch.core import AllocatorConfig, Weights, solve_batch
    from repro_torch.core import baselines as B
    from repro_torch.core.system import feasible, report
    from repro_torch.scenarios import build_classes, get_family, list_families

    cfg = AllocatorConfig(inner="pgd")
    w = Weights.ones(device)
    out = {}
    zero_launches()                                   # the families' path starts here
    for name in list_families():
        params = get_family(name).sample_batch(0, FAMILY_B, N=10, K=50, device=device)
        check(params.g.is_cuda and params.g.shape == (FAMILY_B, 10, 50), f"{name}: not drawn on the card")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "iid_rayleigh":
            check(torch.equal(params.g, iid_pgd[0].g), "iid_rayleigh: not phase 3's draw")
            res, wall = iid_pgd[1], None
        else:
            res = solve_batch(params, w, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check_allocation(params, res, f"families[{name}]")
        a2 = report(params, w, res.alloc)["objective"]
        bases = {
            "equal": B.equal_allocation(params),
            "comm_only": B.comm_opt_only(params, w, 1),
            "comp_only": B.comp_opt_only(params, w),
            "random": B.random_allocation(params, 2),
        }
        rec = dict(solve_s=wall, a2_mean=float(a2.mean()), baselines={})
        for bname, alloc in bases.items():
            what = f"families[{name}] {bname}"
            for leaf in ("f", "P", "X", "rho"):
                check(bool(torch.isfinite(getattr(alloc, leaf)).all()), f"{what}: non-finite {leaf}")
            if bname == "comm_only":           # PGD's relaxed X, as the reference's
                X = alloc.X
                check(bool(((X >= 0) & (X <= 1)).all() and (X.sum(dim=-2) <= 1 + 1e-6).all()),
                      f"{what}: X outside [0, 1] or a subcarrier owned more than once")
            else:
                check_binary_x(params, alloc.X, what)
            obj = report(params, w, alloc)["objective"]
            ok = feasible(params, alloc)
            worse = (a2 > obj + 1e-3) & ok
            check(not bool(worse.any()), f"{what}: Alg. A2 worse than a feasible baseline on "
                  f"{int(worse.sum())} scenarios ({a2[worse].tolist()} > {obj[worse].tolist()})")
            rec["baselines"][bname] = dict(infeasible=int((~ok).sum()), mean=float(obj.mean()))
        out[name] = rec
        infeasible = {b: r["infeasible"] for b, r in rec["baselines"].items()}
        print(f"families[{name}] B={FAMILY_B} N=10 K=50: solve_batch[pgd] "
              + (f"{wall:.3f} s" if wall is not None else "phase 3's")
              + f", Alg. A2 mean objective {rec['a2_mean']:.6g}, feasible; baselines' mean "
              + ", ".join(f"{b} {r['mean']:.6g}" for b, r in rec["baselines"].items())
              + f"; infeasible baselines (not compared): {infeasible}", flush=True)
    n = only_objective_launched("the families' path")    # ... and ends here
    check(n > 0, "the families' path never launched the objective kernel")
    classes = build_classes()
    print("hetero_classes device classes: " + "; ".join(
        f"{c.arch}: c {c.c_cycles:.6g}, f_max {c.f_max_hz:.3g} Hz, p_max {c.p_max_dbm} dBm"
        for c in classes), flush=True)
    return out, n, [c._asdict() for c in classes]


def sweep_pair(params, w, levels, what: str):
    """One exhaustive sweep with the kernel and one with its plain version
    on the same card tensors: the same answer (or, on a tie, values within
    phase 2's tolerance), one kernel launch per chunk of assignments and
    none plain. Returns (kernel result, plain result, record)."""
    import torch

    from repro_torch.core.exhaustive import default_chunk, solve_exhaustive
    from repro_torch.core.system import feasible, report
    from repro_torch.kernels.fedsem_objective import kernel

    N, K = params.N, params.K
    G = (len(levels["f_levels"]) * len(levels["p_levels_dbm"])) ** N * len(levels["rho_levels"])
    chunk = default_chunk(G, N)
    want_launches = -(-N**K // chunk)
    runs, rec = {}, {"launch_shape": [chunk, G, N]}
    for route, use_kernel in (("kernel", True), ("plain", False)):
        before = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex = solve_exhaustive(params, w, **levels, use_kernel=use_kernel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernel.launches - before
        check(n == (want_launches if use_kernel else 0),
              f"{what} {route}: {n} kernel launches, want {want_launches if use_kernel else 0}")
        runs[route] = ex
        rec[route] = dict(wall_s=wall, launches=n, candidates_per_s=ex.n_evaluated / wall,
                          value=float(ex.value))
    k, p = runs["kernel"], runs["plain"]
    same = all(torch.equal(getattr(k.alloc, leaf), getattr(p.alloc, leaf)) for leaf in ("f", "P", "X", "rho"))
    vk, vp = float(k.value), float(p.value)
    check(abs(vk - vp) <= ATOL + RTOL * abs(vp), f"{what}: kernel value {vk} vs plain {vp}")
    check(k.n_evaluated == p.n_evaluated, f"{what}: candidate counts differ")
    for route, ex in runs.items():
        obj = float(report(params, w, ex.alloc)["objective"])
        check(abs(float(ex.value) - obj) <= 1e-5 * abs(obj), f"{what} {route}: value {float(ex.value)} "
              f"!= report objective {obj}")
        check(bool(feasible(params, ex.alloc)), f"{what} {route}: infeasible allocation")
    rec.update(same_allocation=same, n_evaluated=k.n_evaluated)
    if not same:
        print(f"{what}: tie: kernel and plain sweeps pick different candidates, values {vk} and {vp}",
              flush=True)
    return k, p, rec


def phase_oracle(device):
    """Phase 14: the exhaustive oracle through the objective kernel: Table
    II's full grid, then the oracle gate's sweep per family."""
    import numpy as np
    import torch

    from repro_torch.core import AllocatorConfig, Weights, solve
    from repro_torch.core import baselines as B
    from repro_torch.core.system import report
    from repro_torch.scenarios import get_family, list_families

    w = Weights.ones(device)
    levels = {k: np.linspace(*v) for k, v in TABLE2_LEVELS.items()}
    params = get_family("iid_rayleigh").sample(0, N=4, K=5, device=device)
    zero_launches()                                   # the exhaustive path starts here
    ex, _, table2 = sweep_pair(params, w, levels, "Table II sweep")
    gate = {}
    for name in list_families():
        p = get_family(name).sample(2, N=3, K=4, device=device)
        p_hi_dbm = 10.0 * np.log10(float(p.p_max.min())) + 30.0
        gate_levels = dict(f_levels=np.linspace(0.25e9, float(p.f_max.min()), 4),
                           p_levels_dbm=np.linspace(4.0, p_hi_dbm, 3), rho_levels=np.linspace(0.2, 1.0, 4))
        _, _, gate[name] = sweep_pair(p, w, gate_levels, f"oracle gate sweep [{name}]")
    launches = only_objective_launched("the exhaustive path")    # ... and ends here
    check(tuple(table2["launch_shape"]) == SWEEP_SHAPES[0] and table2["kernel"]["launches"] == 1024
          and all(tuple(g["launch_shape"]) == SWEEP_SHAPES[1] and g["kernel"]["launches"] == 2
                  for g in gate.values()),
          f"the sweeps' launches are not phase 2's shapes: {table2['launch_shape']}, "
          f"{[g['launch_shape'] for g in gate.values()]}")
    for route in ("kernel", "plain"):
        r = table2[route]
        print(f"Table II sweep (N 4, K 5, {table2['n_evaluated']} candidates) {route}: "
              f"{r['wall_s']:.4f} s wall, {r['candidates_per_s']:.6g} candidates/s, "
              f"{r['launches']} kernel launches at {tuple(table2['launch_shape'])}, "
              f"value {r['value']:.8g}", flush=True)
    print(f"Table II sweep: kernel and plain give the same allocation: {table2['same_allocation']}; "
          f"the oracle gate's sweeps: " + ", ".join(
              f"{n} {g['kernel']['wall_s']:.4f} s kernel / {g['plain']['wall_s']:.4f} s plain, "
              f"same {g['same_allocation']}" for n, g in gate.items()), flush=True)

    busy = profile_sweep(params, w, levels)

    # Table II's comparison, on the port's draw: Alg. A2 (PGD) and the equal baseline
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a2 = solve(params, w, AllocatorConfig(inner="pgd"))
    torch.cuda.synchronize()
    a2_s = time.perf_counter() - t0
    a2_obj = float(report(params, w, a2.alloc)["objective"])
    eq_obj = float(report(params, w, B.equal_allocation(params))["objective"])
    oracle = float(ex.value)
    projected_years = (4.0**10) * (3.0**10) * 5 * (10.0**50) / table2["kernel"]["candidates_per_s"] / 3.15e7
    claims = {"exhaustive_not_much_better": oracle >= a2_obj - 0.35 * abs(a2_obj),
              "proposed_beats_equal": a2_obj < eq_obj,
              "exhaustive_intractable_at_scale": projected_years > 1e6}
    print(f"Table II instance: Alg. A2 (pgd) objective {a2_obj:.8g} in {a2_s:.3f} s, oracle {oracle:.8g}, "
          f"equal allocation {eq_obj:.8g}; claims (printed, not gated): {claims}", flush=True)
    return dict(table2=table2, gate=gate, profile=busy, a2_objective=a2_obj, a2_s=a2_s,
                equal_objective=eq_obj, claims=claims), launches


def profile_sweep(params, w, levels) -> dict:
    """Where one Table II kernel sweep's time goes: the device's busy time
    (its own events in a `torch.profiler` trace) and the objective kernel's
    share of it, against the unprofiled wall time of a second sweep."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.exhaustive import solve_exhaustive

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_exhaustive(params, w, **levels, use_kernel=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve_exhaustive(params, w, **levels, use_kernel=True)
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    kern = [e for e in on_dev if "fedsem_objective_kernel" in e.key]
    kernel_ms = sum(e.self_device_time_total for e in kern) / 1e3
    kernel_n = sum(e.count for e in kern)
    check(busy_ms > 0 and kernel_n > 0, "the sweep's profile saw no device time or no kernel")
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    out = dict(wall_s=wall, device_busy_ms=busy_ms, busy_share=busy_ms / 1e3 / wall,
               kernel_ms=kernel_ms, kernel_launches=kernel_n,
               top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])
    print(f"Table II kernel sweep, warm: {wall:.4f} s wall; device busy {busy_ms:.3f} ms "
          f"({100 * out['busy_share']:.1f}% of wall), the kernel {kernel_ms:.3f} ms in "
          f"{kernel_n} launches ({1e3 * kernel_ms / max(kernel_n, 1):.3f} us each)", flush=True)
    for key, ms, count in out["top"]:
        print(f"  {ms:9.3f} ms  x{count:<7d} {key[:90]}")
    return out


class FirstCalls(dict):
    """An `AllocService` solver cache that records each key's first-call
    time (``first_call_s``, ending in a synchronize) and every cold call's
    trace (``cold_traces``), for phase 15's report."""

    def __init__(self):
        super().__init__()
        self.first_call_s, self.cold_traces = {}, []

    def __setitem__(self, key, program):
        import torch

        def timed(*args):
            t0 = time.perf_counter()
            out = program(*args)
            torch.cuda.synchronize()
            self.first_call_s.setdefault(key, time.perf_counter() - t0)
            if "warm-refine" not in key:
                self.cold_traces.append(out.trace.cpu())
            return out
        super().__setitem__(key, timed)


def check_completions(requests, completions, what: str) -> None:
    """Every request answered once, with a binary, feasible allocation of
    its exact shape whose `Completion.objective` is `system.objective` on
    the exact-shape scenario to rtol 1e-5."""
    import torch

    from repro_torch.core import Weights
    from repro_torch.core.system import feasible, objective

    check(sorted(c.req_id for c in completions) == list(range(len(requests))),
          f"{what}: not every request answered exactly once")
    for c in completions:
        p = requests[c.req_id]
        a = c.alloc
        check(a.X.shape == (p.N, p.K), f"{what}: request {c.req_id} answered at shape {tuple(a.X.shape)}")
        for leaf in ("f", "P", "X", "rho"):
            check(bool(torch.isfinite(getattr(a, leaf)).all()), f"{what}: non-finite {leaf}")
        check_binary_x(p, a.X, f"{what} request {c.req_id}")
        check(bool((a.X.sum(dim=-1) >= 1).all()), f"{what}: a device owns no subcarrier")
        check(bool(feasible(p, a)), f"{what}: request {c.req_id} infeasible")
        want = float(objective(p, Weights.ones(p.device), a))
        check(abs(c.objective - want) <= 1e-5 * abs(want),
              f"{what}: request {c.req_id} objective {c.objective} != system.objective {want}")


def serving_summary(svc, completions, makespan_s: float, what: str) -> dict:
    """Phase 15's numbers of one pass, printed and returned."""
    import numpy as np

    lat = [c.latency_s for c in completions]
    m = svc.metrics.summary()
    out = dict(requests=len(completions), flushes=m["batches"], makespan_s=makespan_s,
               throughput_rps=len(completions) / makespan_s,
               latency_p50_s=float(np.percentile(lat, 50)), latency_p99_s=float(np.percentile(lat, 99)),
               solve_s=list(svc.metrics.solves_s.sample), mean_batch_size=m["mean_batch_size"],
               cache_misses=m["cache_misses"], cache_hits=m["cache_hits"], compile_s=m["compile_s"])
    print(f"serving[{what}]: {out['requests']} requests in {out['flushes']} flushes, makespan "
          f"{makespan_s:.3f} s, {out['throughput_rps']:.4f} req/s; latency p50 "
          f"{out['latency_p50_s']:.3f} s, p99 {out['latency_p99_s']:.3f} s; solve_s per flush "
          + ", ".join(f"{t:.3f}" for t in out["solve_s"]), flush=True)
    return out


def serve_once(svc, requests):
    """Submit ``requests`` and drain: (completions, solve seconds)."""
    for p in requests:
        svc.submit(p)
    return svc.drain(now=0.0)


def profile_flush(svc, requests) -> dict:
    """One cold flush (solvers already called once) under `torch.profiler`:
    the device's busy time and the objective kernel's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        done, solve_s = serve_once(svc, requests)
    on_dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    kern = [e for e in on_dev if "fedsem_objective_kernel" in e.key]
    check(busy_s > 0 and sum(e.count for e in kern) > 0,
          "the serving flush's profile saw no device time or no kernel")
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    out = dict(requests=len(done), solve_s_profiled=solve_s, device_busy_s=busy_s,
               kernel_ms=sum(e.self_device_time_total for e in kern) / 1e3,
               kernel_launches=sum(e.count for e in kern),
               top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])
    return out


def phase_serving(device):
    """Phase 15: the allocation service at Table-I width on the card: the
    real-clock driver, its virtual replay and a warm pass, then the plain
    scoring path and one profiled flush."""
    import collections

    import torch

    from repro_torch.core import AllocatorConfig, Weights, default_accuracy
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.scenarios import DEFAULT_STREAM_BBAR
    from repro_torch.serve import (
        AllocService, BatchPolicy, RealClockDriver, ServeConfig, WarmStartConfig,
        entry_from_alloc, iters_to_converge, pace_stream, poisson_arrivals, request_signature,
        run_load, same_hardened_assignments, scenario_stream,
    )

    cfg = ServeConfig(policy=BatchPolicy(max_batch=SERVE_MAX_BATCH, max_wait_s=SERVE_MAX_WAIT_S),
                      allocator=AllocatorConfig(inner="pgd"))
    J = cfg.allocator.outer_iters
    cold_launches, warm_launches = J + 2, 2 * J + 3     # trace, selection, scoring; + refine
    check((cold_launches, warm_launches) == (8, 15), "unexpected launch counts per flush")
    requests = scenario_stream(0, SERVE_REQUESTS, scenario="iid_rayleigh", sizes=SERVE_SIZES,
                               bbar=DEFAULT_STREAM_BBAR, device=device)
    check(all(p.g.is_cuda for p in requests), "the stream was not drawn on the card")
    arrivals = poisson_arrivals(1, SERVE_REQUESTS, SERVE_RATE_HZ)
    programs = FirstCalls()
    shapes = collections.Counter()
    launch = kernel.launch

    def counting_launch(args):
        shapes[(args.B, args.G, args.N)] += 1
        return launch(args)

    report = {}
    zero_launches()                                   # the serving path starts here
    kernel.launch = counting_launch
    try:
        # (a) the real-clock driver, paced arrivals, then a drain
        real_svc = AllocService(cfg, executables=programs, device=device)
        driver = RealClockDriver(real_svc)
        futures, t_start = pace_stream(driver, requests, arrivals)
        driver.close(timeout=SERVE_TIMEOUT_S)
        real = [f.result(timeout=0.0) for f in futures]
        report["real"] = serving_summary(real_svc, real, driver.now() - t_start, "real clock")
        check_completions(requests, real, "serving (real clock)")
        n_a = kernel.launches
        check(n_a == cold_launches * real_svc.metrics.batches,
              f"real clock: {n_a} kernel launches for {real_svc.metrics.batches} cold flushes")

        # (b) the same stream and arrivals on the virtual clock
        virt_svc = AllocService(cfg, executables=programs, device=device)
        virt = run_load(virt_svc, requests, arrivals)
        report["virtual"] = serving_summary(virt_svc, virt.completions, virt.makespan_s, "virtual clock")
        check_completions(requests, virt.completions, "serving (virtual clock)")
        n_b = kernel.launches - n_a
        check(n_b == cold_launches * virt_svc.metrics.batches,
              f"virtual clock: {n_b} kernel launches for {virt_svc.metrics.batches} cold flushes")
        check(same_hardened_assignments(real, virt.completions),
              "the real-clock driver and its virtual replay disagree on some request's X")

        # (c) warm: the cache holds (a)'s solutions, so every request hits;
        # the stream again, all at once
        wcfg = WarmStartConfig()
        warm_svc = AllocService(cfg._replace(warmstart=wcfg), executables=programs, device=device)
        w, acc = Weights.ones(device), default_accuracy(device)
        for c in real:
            warm_svc.warm_cache.put(request_signature(requests[c.req_id], w, acc, wcfg),
                                    entry_from_alloc(c.alloc, c.objective))
        n_traces = len(programs.cold_traces)
        warm = run_load(warm_svc, requests, [0.0] * len(requests))
        report["warm"] = serving_summary(warm_svc, warm.completions, warm.makespan_s, "warm")
        check_completions(requests, warm.completions, "serving (warm)")
        check(all(c.warm_hit for c in warm.completions), "warm pass: a request missed the cache")
        n_c = kernel.launches - n_a - n_b
        check(n_c == warm_launches * warm_svc.metrics.batches,
              f"warm: {n_c} kernel launches for {warm_svc.metrics.batches} flushes with a hit")
        cold_obj = {c.req_id: c.objective for c in virt.completions}
        for c in warm.completions:
            cold = cold_obj[c.req_id]
            check(c.objective <= cold + 1e-5 * max(1.0, abs(cold)),
                  f"warm: request {c.req_id} objective {c.objective} > cold {cold}")
        # the cold traces of the warm flushes' rows (their real rows lead)
        occupancy = warm_svc.metrics.occupancy.sample
        cold_iters = [iters_to_converge(t[i]) for t, occ in zip(programs.cold_traces[n_traces:], occupancy)
                      for i in range(round(occ * SERVE_MAX_BATCH))]
        stats = warm_svc.warm_cache.stats()
        m = warm_svc.metrics.summary()
        report["warm"].update(hit_rate=stats["warm_cache_hit_rate"], warm_iters_mean=m["warm_iters_mean"],
                              cold_iters_mean=sum(cold_iters) / len(cold_iters),
                              improved=sum(c.objective < cold_obj[c.req_id] for c in warm.completions))
        print(f"serving[warm]: hit rate {stats['warm_cache_hit_rate']:.3f}; outer iterations to "
              f"converge {report['warm']['warm_iters_mean']:.3f} warm vs "
              f"{report['warm']['cold_iters_mean']:.3f} cold on the same rows; "
              f"{report['warm']['improved']} of {len(warm.completions)} objectives improved", flush=True)

        # the small bucket's requests at cut depth (a full-depth flush holds
        # too many events for the profiler): a kernel flush, the same under
        # the profiler, and the plain scoring path
        small = [p for p in requests if (p.N, p.K) == SERVE_SIZES[1]][:SERVE_MAX_BATCH]
        check(bool(small), f"the stream holds no {SERVE_SIZES[1]} request")
        cut = cfg._replace(allocator=AllocatorConfig(inner="pgd", outer_iters=1, pgd=PGDConfig(steps=100)))
        cut_programs = {}
        n_before = kernel.launches
        twin, twin_s = serve_once(AllocService(cut, cut_programs, device=device), small)
        prof = profile_flush(AllocService(cut, cut_programs, device=device), small)
        check(kernel.launches - n_before == 2 * (cut.allocator.outer_iters + 2),
              "the cut-depth flushes' launches")
        plain_cfg = cut._replace(allocator=cut.allocator._replace(use_kernel_objective=False))
        n_before = kernel.launches
        plain, plain_s = serve_once(AllocService(plain_cfg, device=device), small)
        check(kernel.launches == n_before, "the plain scoring path launched the kernel")
    finally:
        kernel.launch = launch
    launches = only_objective_launched("the serving path")    # ... and ends here

    by_id = {c.req_id: c for c in twin}
    for c in plain:
        k = by_id[c.req_id]
        for leaf in ("f", "P", "X", "rho"):
            check(torch.equal(getattr(c.alloc, leaf), getattr(k.alloc, leaf)),
                  f"plain scoring path: request {c.req_id}'s {leaf} differs from the kernel path's")
        check(abs(c.objective - k.objective) <= ATOL + RTOL * abs(k.objective),
              f"plain scoring path: request {c.req_id} objective {c.objective} vs kernel {k.objective}")
    busy = prof["device_busy_s"] / twin_s
    report.update(first_call_s={str(k): v for k, v in programs.first_call_s.items()},
                  launch_shapes={str(k): v for k, v in shapes.items()}, launches=launches,
                  profile=dict(prof, unprofiled_solve_s=twin_s, busy_share=busy),
                  plain_solve_s=plain_s)
    for key, t in programs.first_call_s.items():
        print(f"serving cache: first call {t:.3f} s for bucket {key[0][:2]}, {key[1]} slots"
              + (f", warm-refine {key[-1]} candidate(s)" if "warm-refine" in key else ""), flush=True)
    print(f"serving: {launches} kernel launches ({cold_launches} per cold flush, {warm_launches} per "
          f"flush with a hit, 0 on the plain path); launch shapes {dict(shapes)}", flush=True)
    print(f"serving, one cold flush of {prof['requests']} {SERVE_SIZES[1]} requests at cut depth "
          f"(1 outer iteration, 100 PGD steps), profiled: device busy {prof['device_busy_s']:.4f} s "
          f"= {100 * busy:.2f}% of the unprofiled flush's {twin_s:.3f} s "
          f"({prof['solve_s_profiled']:.3f} s profiled); the kernel {prof['kernel_ms']:.3f} ms in "
          f"{prof['kernel_launches']} launches; the plain scoring path's flush {plain_s:.3f} s, "
          "the same allocations", flush=True)
    for key, ms, count in prof["top"]:
        print(f"  {ms:9.3f} ms  x{count:<7d} {key[:90]}")

    # the kernel at the serving path's launch shapes, against its plain version
    report["kernel_cases"] = serving_kernel_cases(device, shapes)
    return report, launches


def serving_kernel_cases(device, shapes) -> list:
    """The objective kernel at each launch shape of the serving path that
    phase 2 does not time: graph-replay time, plain version, bound."""
    import torch

    from repro_torch.kernels.fedsem_objective import kernel, ref

    gen = torch.Generator(device=device).manual_seed(4321)
    ab = tuple(torch.tensor(v, device=device) for v in AB)
    timed = {(16, 3, 10), (48, 1, 10), (64, 8192, 8)} | set(SWEEP_SHAPES)
    cases = []
    for B, G, N in sorted(set(shapes) - timed):
        args, mask, kap = grid_inputs(gen, B, G, N, device)
        kw = dict(xi=XI, eta=ETA, check_feasible=False)
        run_k = lambda: kernel.objective_batch(*args, mask, *kap, *AB, **kw)
        run_p = lambda: ref.objective_grid_batch(*args, *kap, accuracy_ab=ab, dev_mask=mask, **kw)
        err = compare(run_k(), run_p(), f"serving objective_batch{(B, G, N)}")
        prep = kernel.prepare(*args, mask, *kap, *AB, **kw)
        case = dict(shape=[B, G, N], launches=shapes[(B, G, N)], max_abs_err=err,
                    ms=graph_ms(lambda: kernel.launch(prep)), plain_ms=graph_ms(run_p),
                    **dict(zip(("bound_ms", "bound_by"), bound(B, G, N, False))))
        cases.append(case)
        print(f"serving objective_batch{(B, G, N)} x{case['launches']}: device kernel "
              f"{case['ms']:.6f} ms, plain {case['plain_ms']:.6f} ms, bound {case['bound_ms']:.7f} ms "
              f"({case['bound_by']}); max abs err {err:.3g}", flush=True)
    torch.cuda.synchronize()
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, help="also write the full report as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one short solve per config (device busy share)")
    args = ap.parse_args()
    # torch.compile's caches (phase 4's flex_attention) stay inside the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "torch_compile" / sub))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return EXIT_NO_CARD
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the port (src/repro_torch) is not beside this script", file=sys.stderr)
        return EXIT_NO_PORT
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    all_kernels = (kernel, flash_kernel, wkv_kernel, scan_kernel)
    with concurrent.futures.ThreadPoolExecutor(len(all_kernels)) as pool:
        builds = [pool.submit(k.build) for k in all_kernels]
        built = [b.result() for b in builds]
    for k in all_kernels:
        k.load()
    build_s = time.perf_counter() - t0
    for path, log in built:
        print(f"build: {path.name} (all builds together: {build_s:.2f} s)", flush=True)
        for line in log.strip().splitlines():
            print(f"  ptxas: {line.strip()}")
    # the WKV6 and scan kernels: registers of every instantiation, no spills
    ptxas = {}
    for k in (wkv_kernel, scan_kernel):
        name = k.__name__.split(".")[-2]
        rep = ptxas_report(built[all_kernels.index(k)][1])
        if not rep:
            print(f"ptxas {name}: library built earlier, no report", flush=True)
            continue
        regs = sorted(r["registers"] for r in rep.values())
        spills = {f: r["spill_bytes"] for f, r in rep.items() if r["spill_bytes"]}
        main_fn = next(f for f in rep if MAIN_INSTANTIATION[name] in f)
        ptxas[name] = dict(main=rep[main_fn], registers=[regs[0], regs[-1]],
                           instantiations=len(rep), spilling=spills)
        print(f"ptxas {name}: {len(rep)} instantiations, {regs[0]}-{regs[-1]} registers, main "
              f"path's {rep[main_fn]['registers']} registers, {rep[main_fn]['stack_bytes']} bytes "
              f"stack; spills: {spills or 'none'}", flush=True)
        check(not spills, f"{name}: ptxas spills registers: {spills}")
    flash_sass = flash_tensor_core_sass(built[all_kernels.index(flash_kernel)][0])
    print("flash bf16 kernel (flash_fwd_kernel_sm90) SASS: "
          + ", ".join(f"hd {hd}: {n} HGMMA" for hd, n in sorted(flash_sass.items())), flush=True)

    # phase 2: kernel vs plain version
    cases = phase_kernel(device)
    for c in cases:
        print(f"{c['entry']}{tuple(c['shape'])} feasible={c['check_feasible']}: device "
              f"kernel {c['ms']:.6f} ms, plain {c['plain_ms']:.6f} ms, bound "
              f"{c['bound_ms']:.6f} ms ({c['bound_by']}); per eager call: wrapper "
              f"{c['wrapper_ms']:.5f} ms, plain {c['plain_eager_ms']:.5f} ms; "
              f"max abs err {c['max_abs_err']:.3g}", flush=True)

    # phase 3: the allocator slice
    solves, launches, iid_pgd = phase_slice(device)
    profiled = phase_profile(device) if args.profile else None

    # phase 4: the flash kernel vs its plain version
    flash_cases = phase_flash(device)

    # phases 5 and 6: the Gemma-2 slice (prefill, then ServeLoop)
    lm, gemma_launches = phase_lm(device, *LM_PATHS[0])

    # phase 7: the WKV6 kernel vs its plain version
    wkv_cases = phase_wkv(device)

    # phases 8 and 9: the RWKV slice (prefill, then ServeLoop)
    rwkv, rwkv_launches = phase_lm(device, *LM_PATHS[1])
    main_wkv = next(c for c in wkv_cases if c["case"] == WKV_MAIN)

    # phase 10: the selective-scan kernel vs its plain version
    scan_cases = phase_scan(device)

    # phases 11 and 12: the Jamba slice (prefill, then ServeLoop)
    jamba, jamba_launches = phase_lm(device, *LM_PATHS[2])
    main_scan = next(c for c in scan_cases if c["case"] == SCAN_MAIN)
    paths = {"gemma2_2b": gemma_launches, "rwkv6_1_6b": rwkv_launches,
             "jamba_1_5_large_398b": jamba_launches}
    by_path = lambda name: {arch: n[name] for arch, n in paths.items() if n[name]}

    # phase 13: the scenario families and the baselines
    families, families_launches, classes = phase_families(device, iid_pgd)

    # phase 14: the exhaustive oracle through the objective kernel
    oracle, oracle_launches = phase_oracle(device)

    # phase 15: the allocation service on the card
    serving, serving_launches = phase_serving(device)
    objective_by_path = {"solve_batch": launches, "families": families_launches,
                         "exhaustive": oracle_launches, "serving": serving_launches}

    trace_case = next(c for c in cases if c["shape"] == [48, 1, 10] and not c["check_feasible"])
    main_flash = next(c for c in flash_cases if c["case"] == "gemma2_2b global")
    record = {"kernels": [{
        "name": "fedsem_objective_batch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fedsem_objective/csrc/objective.cu",
        "replaces": "src/repro/kernels/fedsem_objective/kernel.py:171",
        "launches": sum(objective_by_path.values()),
        "launches_by_path": objective_by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": trace_case["ms"],
        "plain_ms": trace_case["plain_ms"],
        "bound_ms": trace_case["bound_ms"],
        "bound_by": trace_case["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": sum(by_path("flash_attention").values()),
        "launches_by_path": by_path("flash_attention"),
        "max_abs_err": max(c["max_abs_err"] for c in flash_cases),
        "ms": main_flash["ms"],
        "plain_ms": main_flash["plain_ms"],
        "bound_ms": main_flash["bound_ms"],
        "bound_by": main_flash["bound_by"],
        "library_ms": main_flash["library_ms"],
    }, {
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:47",
        "launches": sum(by_path("rwkv6_scan").values()),
        "launches_by_path": by_path("rwkv6_scan"),
        "max_abs_err": max(c["max_abs_err"] for c in wkv_cases),
        "ms": main_wkv["ms"],
        "plain_ms": main_wkv["plain_ms"],
        "bound_ms": main_wkv["bound_ms"],
        "bound_by": main_wkv["bound_by"],
        "library_ms": None,
        "ptxas": ptxas.get("rwkv6_scan"),
    }, {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:48",
        "launches": sum(by_path("mamba_scan").values()),
        "launches_by_path": by_path("mamba_scan"),
        "max_abs_err": max(c["max_abs_err"] for c in scan_cases),
        "ms": main_scan["ms"],
        "plain_ms": main_scan["plain_ms"],
        "bound_ms": main_scan["bound_ms"],
        "bound_by": main_scan["bound_by"],
        "library_ms": None,
        "ptxas": ptxas.get("mamba_scan"),
    }]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            dict(build_s=build_s, flash_sass=flash_sass, cases=cases, solves=solves,
                 profile=profiled, flash_cases=flash_cases, lm=lm, wkv_cases=wkv_cases, rwkv=rwkv,
                 scan_cases=scan_cases, jamba=jamba, families=families, classes=classes,
                 oracle=oracle, serving=serving, record=record, card=smi), indent=1))
    print(json.dumps(record))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
