#!/usr/bin/env python3
"""Repeat chip_smoke.py's profiled prefill and hold each trace's kernel
launches to the count the model's layers give.

    python3 tools/torch_profile_repeat.py [--arch A] [--lead-ins 0 3000]
                                          [--repeats 1] [--minutes M] [--gap S]

Builds the kernel the arch's layers run from this checkout, makes ``--arch``
(Gemma-2 2B by default) at full width in bfloat16 from seed 0 with
chip_smoke.py's batch (B 1, S 8192 for Gemma-2, 4096 otherwise), and calls
`chip_smoke.profile_prefill` with `PROFILE_LEAD_IN` set to each of
``--lead-ins`` in turn (3000 is chip_smoke.py's; 0 profiles without a
lead-in): ``--repeats`` rounds, then more until ``--minutes`` have passed
since the start, ``--gap`` seconds between profiles (the profiler's misses
come late in a long process). A profile misses when `profile_prefill`'s
gate (the trace's launches == the layers' count) fails. Prints one line per
profile and a summary; exits 1 if any profile missed. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--lead-ins", type=int, nargs="+", default=[0, 3000])
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--minutes", type=float, default=0.0)
    ap.add_argument("--gap", type=float, default=0.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_repeat: no CUDA card", file=sys.stderr)
        return 4
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cfg = get_config(args.arch)
    kinds = M.layer_kinds(cfg)
    name = cs.KERNEL_OF_KIND[kinds[0]]
    importlib.import_module(f"repro_torch.kernels.{name}.kernel").build()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    S = 8192 if cfg.name.startswith("gemma") else 4096
    batch = cs.lm_batch(cfg, 1, S, torch.Generator(device=device).manual_seed(1))
    want = {k: sum(cs.KERNEL_OF_KIND[kind] == k for kind in kinds) for k in cs.KERNEL_SYMBOLS}
    for _ in range(2):                                   # the cold and the warm call
        M.prefill(params, cfg, batch, use_kernel=True)

    runs = []
    while (len(runs) < args.repeats * len(args.lead_ins)
           or time.perf_counter() - t_start < 60 * args.minutes):
        if args.gap and runs:
            time.sleep(args.gap)
        cs.PROFILE_LEAD_IN = args.lead_ins[len(runs) % len(args.lead_ins)]
        run = dict(lead_in=cs.PROFILE_LEAD_IN, at_s=time.perf_counter() - t_start, miss=None)
        try:
            prof = cs.profile_prefill(M, params, cfg, batch, want)
            run["launches"] = prof["kernel_launches"][name]
        except cs.SmokeFailure as e:
            run["miss"] = str(e)
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {lead_in: dict(profiles=sum(r["lead_in"] == lead_in for r in runs),
                             misses=sum(r["lead_in"] == lead_in and bool(r["miss"]) for r in runs))
               for lead_in in args.lead_ins}
    print(json.dumps({"arch": args.arch, "want": want[name], "summary": summary}), flush=True)
    return 1 if any(r["miss"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
