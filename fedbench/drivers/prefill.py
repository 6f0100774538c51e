"""Prefill traffic: one client in a closed loop, each request one prompt of
the next length in the traffic's fixed cycle, through the program's
`models.model.prefill` on weights the benchmark drew.

The window runs whole cycles: requests are issued back to back while less
than ``seconds`` have passed, and the cycle in progress is finished, so
every run holds the same mix of lengths. A request's latency runs from its
issue to its logits on the device (a synchronize). After the window, one
finished request of each length (the longest among them), chosen from the
seed, is judged against the configuration's plain reference at the
traffic's compared positions (`yardstick.logits`).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fedbench import harness
from fedbench.yardstick import logits as cmp
from fedbench.yardstick import trace as tr


class Record:
    """What the per-layer readers read (`fedbench/metrics/`)."""

    def __init__(self, model, matmul_params, lengths, window_s, summary):
        self.model, self.matmul_params = model, matmul_params
        self.kind = "prefill"
        self.lengths = lengths          # every request of the window, in order
        self.window_s = window_s
        self.trace = summary            # `trace.summarize` of the window, or None


def model_config(model: dict):
    """The program's `ModelConfig` for a configuration's ``model`` sizes."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})


class Setup:
    """A cell's program and inputs, made from the seed: the weights (drawn
    on the device in the program's tree layout, handed to the program and to
    the reference alike), the program's `LM` over them, and the token pool
    every prompt is a slice of."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.models import model as M

        self.M, self.device = M, device
        self.model = model = cell.config["model"]
        self.ref = cell.reference()
        self.mcfg = model_config(model)
        self.spec = self.ref.tree_spec(model)
        gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "weights"))
        self.tree = harness.make_tree(self.spec, gen, getattr(torch, model["dtype"]), device)
        self.lm = M.LM(self.mcfg, self.tree)
        traffic = cell.traffic
        self.lengths = list(traffic["lengths"])
        tgen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "tokens"))
        self.pool_size = traffic["token_pool"]
        self.pool = torch.randint(0, model["vocab"], (self.pool_size,), generator=tgen, device=device)
        self.offsets = np.random.default_rng(harness.sub_seed(seed, "offsets"))
        self.n_cmp = traffic["compare"]["positions"]
        self.where = {L: torch.tensor(cmp.compared_positions(L, self.n_cmp), device=device)
                      for L in set(self.lengths)}

    def next_offset(self, L: int) -> int:
        return int(self.offsets.integers(0, self.pool_size - L + 1))

    def prefill(self, off: int, L: int):
        """The program's prefill of the prompt at ``off`` of ``L`` tokens."""
        return self.M.prefill(self.lm, self.mcfg, {"tokens": self.pool[None, off:off + L]})

    def reference(self, off: int, L: int, fp8: bool = False):
        """The plain reference's logits of that prompt at the compared
        positions (``fp8``: the control's)."""
        return self.ref.logits(self.model, self.tree, self.pool[off:off + L],
                               cmp.compared_positions(L, self.n_cmp), fp8=fp8)


def run(cell, *, seed: int, seconds: float, trace: bool, device) -> dict:
    st = Setup(cell, seed, device)
    lengths = st.lengths
    cycle = len(lengths)
    for L in sorted(set(lengths)):                       # warm up every length the cell uses
        out = st.prefill(0, L)
        harness.sync(device)
        del out
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # one finished request of each length is kept for the check, drawn
    # from the seed over all that finish (a reservoir of one)
    pick = np.random.default_rng(harness.sub_seed(seed, "sample"))
    kept: dict[int, tuple] = {}
    seen: dict[int, int] = {}
    done, spans = [], []
    tracer = tr.DeviceTrace() if trace else None
    if tracer:
        tracer.start()
    setup_s = harness.process_age_s()
    t0 = time.perf_counter()
    w0 = tr.now_ns()
    i = 0
    while True:
        L = lengths[i % cycle]
        off = st.next_offset(L)
        a, s0 = time.perf_counter(), tr.now_ns()
        out = st.prefill(off, L)
        harness.sync(device)
        b, s1 = time.perf_counter(), tr.now_ns()
        spans.append((s0, s1, f"prefill dispatch, {L} tokens"))
        seen[L] = seen.get(L, 0) + 1
        if pick.integers(0, seen[L]) == 0:
            kept[L] = (off, out[0, st.where[L]])
        del out
        done.append((L, b - a))
        i += 1
        if i % cycle == 0 and b - t0 >= seconds:
            break
    harness.sync(device)
    window_s = time.perf_counter() - t0
    w1 = tr.now_ns()
    summary = tr.summarize(tracer.stop(), (w0, w1), spans) if tracer else None
    device_rec = harness.device_record(device, cell.chips)
    st.lm = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    readings = cmp.readings([(got, st.reference(off, L)) for L, (off, got) in sorted(kept.items())])
    correct, compared = harness.judge(readings, cell.limits)
    failed = readings["non_finite_positions"]

    tokens_done = sum(L for L, _ in done)
    lat_ms = [1e3 * t for _, t in done]
    if trace:
        record = Record(st.model, harness.spec_numel(st.spec, matmul_only=True),
                        [L for L, _ in done], window_s, summary)
        metrics = harness.read_metrics(cell, record)
        device_rec.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = tr.breakdown(summary)
    else:
        values = {"prefill_tokens_per_s": tokens_done / window_s,
                  "prefill_p95_ms": float(np.percentile(lat_ms, 95)),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        breakdown = None
    return {"correct": correct and failed == 0, "attempted": len(done), "failed": failed,
            "metrics": metrics, "device": device_rec, "compared": compared,
            "breakdown": breakdown}
