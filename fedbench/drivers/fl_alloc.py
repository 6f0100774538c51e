"""FL-round allocation traffic: Alg. A2 (`core.solve_batch`) plans the next
round of a batch of FedSem cells whose devices fine-tune the configuration's
model, as `fl.alloc_backend.PlannedBackend` calls it, and the program's
scoring path (`core.batch_objectives`, the objective kernel) prices each
allocation.

Every scenario follows the traffic's Table-I law (`yardstick.scenarios`),
drawn from the seed, with the FL upload D_n of the model: its parameters
at ``bits_per_param`` bits (the FL driver's `tree_bits`), counted from the
configuration's tree. Solves run back to back, each on the next of a few
batches drawn in set-up, while less than ``seconds`` have passed. After
the window every answer is judged by the system model
(`yardstick.system_model.judge`).
"""
from __future__ import annotations

import time

import torch

from fedbench import harness
from fedbench.yardstick import scenarios
from fedbench.yardstick import system_model as sm
from fedbench.yardstick import trace as tr


class Record:
    """What the per-layer readers read (`fedbench/metrics/`)."""

    def __init__(self, solves, batch, window_s, summary):
        self.kind = "fl_alloc"
        self.solves, self.batch = solves, batch
        self.window_s = window_s
        self.trace = summary


def allocator_config(spec: dict):
    """The program's `AllocatorConfig` for a traffic's ``allocator`` entry."""
    from repro_torch.core import AllocatorConfig
    from repro_torch.core.pgd import PGDConfig

    return AllocatorConfig(outer_iters=spec["outer_iters"], inner=spec["inner"],
                           pgd=PGDConfig(steps=spec["pgd_steps"]))


def system_params(sc: dict):
    """The program's `SystemParams` of a drawn batch."""
    from repro_torch.core import SystemParams

    keys = ("g", "c", "d", "D", "C", "p_max", "f_max", "t_sc_max", "N", "K", "B", "N0", "xi", "eta", "q")
    return SystemParams(**{k: sc[k] for k in keys})


def solve(params, weights, cfg, accuracy):
    """One planned round: the allocation and the objective its scoring path
    reports, (alloc, objective (B,))."""
    import repro_torch.core as core

    res = core.solve_batch(params, weights, cfg, accuracy)
    return res.alloc, core.batch_objectives(params, weights, res.alloc, accuracy)


class Setup:
    """A cell's inputs, made from the seed: ``batches`` of scenarios (dicts of
    tensors, `scenarios.draw`) and the program's `SystemParams` of each; the
    weights, the accuracy fit and the solver's config."""

    def __init__(self, cell, seed: int, device):
        from repro_torch.core import AccuracyFn, Weights

        traffic = cell.traffic
        self.traffic, self.device = traffic, device
        law = traffic["scenario"]
        scenarios.check_law(law)
        spec = cell.reference().tree_spec(cell.config["model"])
        D_bits = scenarios.tree_bits(harness.spec_numel(spec), traffic["bits_per_param"])
        self.B = traffic["batch"]
        gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "scenarios"))
        self.batches = [scenarios.draw(gen, self.B, law, D_bits, device) for _ in range(traffic["batches"])]
        self.params = [system_params(sc) for sc in self.batches]
        self.kappa, self.acc = tuple(traffic["kappa"]), tuple(traffic["accuracy_ab"])
        scalar = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        self.weights = Weights(*map(scalar, self.kappa))
        self.accuracy = AccuracyFn(*map(scalar, self.acc))
        self.cfg = allocator_config(traffic["allocator"])

    def solve(self, j: int, cfg=None):
        return solve(self.params[j], self.weights, cfg or self.cfg, self.accuracy)

    def judge(self, j: int, alloc: dict, objective) -> dict:
        """The system model's numbers of batch ``j``'s answers (`alloc`:
        {"f", "P", "X", "rho"} arrays or tensors)."""
        host = lambda x: x.detach().cpu().double().numpy() if hasattr(x, "detach") else x
        return sm.judge(sm.as_numpy(self.batches[j]), {k: host(v) for k, v in alloc.items()},
                        host(objective), self.kappa, self.acc, self.traffic["feasibility_tol"])


def leaves(alloc) -> dict:
    return {k: getattr(alloc, k) for k in ("f", "P", "X", "rho")}


def run(cell, *, seed: int, seconds: float, trace: bool, device) -> dict:
    st = Setup(cell, seed, device)
    st.solve(0, allocator_config(st.traffic["warmup_allocator"]))   # warm up the shapes
    harness.sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    answers, spans = [], []
    tracer = tr.DeviceTrace() if trace else None
    if tracer:
        tracer.start()
    setup_s = harness.process_age_s()
    t0 = time.perf_counter()
    w0 = tr.now_ns()
    while True:
        j = len(answers) % len(st.params)
        s0 = tr.now_ns()
        alloc, obj = st.solve(j)
        harness.sync(device)
        spans.append((s0, tr.now_ns(), "solve_batch and its scoring (host dispatch)"))
        answers.append((j, alloc, obj))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    w1 = tr.now_ns()
    summary = tr.summarize(tracer.stop(), (w0, w1), spans) if tracer else None
    device_rec = harness.device_record(device, cell.chips)

    worst = ("objective_gap", "rho_gap", "objective_ratio", "unmoved_share")
    readings = dict(infeasible=0, **dict.fromkeys(worst, 0.0))
    for j, alloc, obj in answers:
        got = st.judge(j, leaves(alloc), obj)
        readings["infeasible"] += got["infeasible"]
        for k in worst:
            readings[k] = max(readings[k], got[k])
    correct, compared = harness.judge(readings, cell.limits)

    n = len(answers) * st.B
    if trace:
        record = Record(len(answers), st.B, window_s, summary)
        metrics = harness.read_metrics(cell, record)
        device_rec.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = tr.breakdown(summary)
    else:
        values = {"alloc_scenarios_per_s": n / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
        breakdown = None
    return {"correct": correct, "attempted": n, "failed": readings["infeasible"],
            "metrics": metrics, "device": device_rec, "compared": compared,
            "breakdown": breakdown}
