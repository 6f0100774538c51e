"""The port's allocation service (`repro_torch.serve`: `AllocService`,
`run_load`, the metrics) against the JAX reference, on the CPU, plus the
serving rows of the equivalence table the port proves about itself.

Held to the reference, on the same numpy requests and arrivals: every
request's hardened X, the flushes (their buckets and members), the
metrics' keys and counts; `Completion.objective` at rtol 1e-5, or where a
request's objective differs by more, one-sided against the reference's own
spread over one-ulp copies of the gains, at the whole-solve tolerance of
`tests/test_torch_allocator.py` (rtol 1e-4 plus 3x that spread). The
arrivals come in bursts far apart, so which requests share a flush does
not depend on how long a solve takes in either package.

Inside the port, bit for bit: padded == exact on X, co-batching (a request
answers alike alone and in another slot beside other requests), the
uniform-tenant and mixed-tenant rows; and the one-ulp B split (built with
`math.nextafter`) lands in one queue.
"""
import math

import numpy as np
import pytest
import torch

from repro.core import AllocatorConfig as JConfig
from repro.core.pgd import PGDConfig as JPGD
from repro.serve import AllocService as JAllocService, BatchPolicy as JBatchPolicy
from repro.serve import ServeConfig as JServeConfig, run_load as jrun_load
from repro.serve.metrics import Reservoir as JReservoir, ServiceMetrics as JServiceMetrics
from repro_torch import bridge
from repro_torch.core import AllocatorConfig, Weights, solve_batch, stack_accuracy, stack_params
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.system import feasible, objective
from repro_torch.serve import (
    AllocService, BatchPolicy, Reservoir, ServeConfig, ServiceMetrics, WarmStartConfig,
    percentile, run_load,
)
from torch_parity_spread import ulp_inputs
from torch_port_util import both_params, np_, numpy_scenarios

torch.set_num_threads(1)

#: the reference's serving test config (tests/test_serve_alloc.py:SERVE_CFG)
TINY = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=40))
JTINY = JConfig(inner="pgd", outer_iters=2, pgd=JPGD(steps=40))
SERVE = ServeConfig(policy=BatchPolicy(max_batch=2, max_wait_s=0.01), allocator=TINY)
JSERVE = JServeConfig(policy=JBatchPolicy(max_batch=2, max_wait_s=0.01), allocator=JTINY)
#: the parity stream: (N, K) per request, all at the Table-I bbar, and
#: arrivals in bursts 100 s apart (longer than any solve)
SIZES = ((3, 8), (4, 8), (3, 8), (4, 12), (3, 8), (4, 8))
ARRIVALS = (0.0, 0.0, 0.0, 0.0, 100.0, 100.0)
BBAR = 400e3
#: the whole-solve tolerance of tests/test_torch_allocator.py for objectives
OBJ_RTOL, PLANNED_RTOL, SPREAD_FACTOR = 1e-5, 1e-4, 3.0


def _numpy_stream(first_seed=40):
    return [numpy_scenarios(first_seed + i, N=n, K=k, B=BBAR * k) for i, (n, k) in enumerate(SIZES)]


def _flushes(completions):
    """[(bucket, sorted req_ids)] per flush, in order (a virtual run lists a
    flush's completions together; they share its solve time)."""
    out, key = [], None
    for c in completions:
        if key != (c.bucket, c.solve_s):
            key = (c.bucket, c.solve_s)
            out.append((c.bucket, []))
        out[-1][1].append(c.req_id)
    return [(b, sorted(ids)) for b, ids in out]


@pytest.fixture(scope="module")
def parity():
    """The parity stream through both packages' `run_load`."""
    stream = _numpy_stream()
    pairs = [both_params(*s) for s in stream]
    jsvc = JAllocService(JSERVE)
    ref = jrun_load(jsvc, [p[0] for p in pairs], ARRIVALS)
    port = run_load(AllocService(SERVE, device="cpu"), [p[1] for p in pairs], ARRIVALS)
    return dict(stream=stream, pairs=pairs, ref=ref, port=port, executables=jsvc.executables)


def test_run_load_matches_the_references_x_flushes_and_buckets(parity):
    ref, port = parity["ref"], parity["port"]
    J = {c.req_id: c for c in ref.completions}
    T = {c.req_id: c for c in port.completions}
    assert sorted(J) == sorted(T) == list(range(len(SIZES)))
    for i in J:
        np.testing.assert_array_equal(np_(T[i].alloc.X), np.asarray(J[i].alloc.X), err_msg=f"req {i}")
        assert T[i].bucket == J[i].bucket
        assert bool(feasible(parity["pairs"][i][1], T[i].alloc))
    assert _flushes(port.completions) == _flushes(ref.completions)
    for key in ("requests", "completed", "batches", "mean_batch_size", "batch_occupancy_mean"):
        assert port.summary[key] == ref.summary[key], key


def test_run_load_objectives_match_the_references(parity):
    """Each `Completion.objective` against the reference's at rtol 1e-5; a
    request beyond it is held to the reference's spread over one-ulp copies
    of the stream's gains (the reference's own rounding noise), one-sided:
    no worse than that spread's top plus the whole-solve tolerance."""
    J = {c.req_id: c.objective for c in parity["ref"].completions}
    T = {c.req_id: c.objective for c in parity["port"].completions}
    beyond = [i for i in J if abs(T[i] - J[i]) > OBJ_RTOL * abs(J[i])]
    if not beyond:
        return
    members = [[] for _ in SIZES]
    copies = [ulp_inputs(arrays, 4, 200 + i) for i, (arrays, _) in enumerate(parity["stream"])]
    for m in range(1, 4):
        jreqs = [both_params(copies[i][m], meta)[0] for i, (_, meta) in enumerate(parity["stream"])]
        run = jrun_load(JAllocService(JSERVE, executables=parity["executables"]), jreqs, ARRIVALS)
        for c in run.completions:
            members[c.req_id].append(c.objective)
    for i in beyond:
        objs = [J[i]] + members[i]
        lo, hi = min(objs), max(objs)
        limit = hi + PLANNED_RTOL * abs(J[i]) + SPREAD_FACTOR * (hi - lo)
        assert T[i] <= limit, (i, T[i], J[i], lo, hi)


def test_objective_is_system_objective_on_the_exact_shape(parity):
    """`Completion.objective`, scored on the padded batch, equals
    `system.objective` of the returned allocation on the exact-shape
    scenario to rtol 1e-5."""
    for c in parity["port"].completions:
        want = float(objective(parity["pairs"][c.req_id][1], Weights.ones(), c.alloc))
        assert c.objective == pytest.approx(want, rel=1e-5)


def test_metrics_summary_has_the_references_keys(parity):
    assert list(ServiceMetrics().summary()) == list(JServiceMetrics().summary())
    assert list(parity["port"].summary) == list(parity["ref"].summary)


def _port_requests(sizes, first_seed=60):
    return [both_params(*numpy_scenarios(first_seed + i, N=n, K=k, B=BBAR * k))[1]
            for i, (n, k) in enumerate(sizes)]


def _answers(svc, requests, **submit):
    for p in requests:
        svc.submit(p, **submit)
    return {c.req_id: c for c in svc.drain(now=0.0)[0]}


def test_padded_equals_exact():
    """A request padded into a bucket gets the hardened X of its exact-shape
    solve."""
    requests = _port_requests(((3, 8), (4, 12)))
    exact = _answers(AllocService(SERVE._replace(buckets=None), device="cpu"), requests)
    padded = _answers(AllocService(SERVE, device="cpu"), requests)
    for i in exact:
        assert padded[i].bucket != (requests[i].N, requests[i].K)
        assert torch.equal(padded[i].alloc.X, exact[i].alloc.X)


def test_cobatching_is_bitforbit():
    """A request's answer does not depend on its slot or its batch-mates:
    alone (slot 0, replicated), in slot 1 beside another request, and in
    slot 0 beside a third, every leaf and the objective are equal."""
    r, a, b = _port_requests(((3, 8), (4, 8), (3, 8)))
    svc = AllocService(SERVE, device="cpu")
    runs = [
        _answers(svc, [r])[0],
        _answers(AllocService(SERVE, svc.executables, device="cpu"), [a, r])[1],
        _answers(AllocService(SERVE, svc.executables, device="cpu"), [r, b])[0],
    ]
    for c in runs[1:]:
        for leaf in ("f", "P", "X", "rho"):
            assert torch.equal(getattr(c.alloc, leaf), getattr(runs[0].alloc, leaf)), leaf
        assert c.objective == runs[0].objective


def test_uniform_tenant_rows_are_bitforbit():
    """A uniform stack of one fit (``acc_batched=True``) solves exactly like
    that fit broadcast to every row."""
    pb = stack_params(_port_requests(((3, 8), (3, 8))))
    acc = bridge.accuracy_from_numpy({"a": 0.6356, "b": 0.4025}, device="cpu")
    bcast = solve_batch(pb, Weights.ones(), TINY, acc)
    stacked = solve_batch(pb, Weights.ones(), TINY, stack_accuracy([acc, acc]), acc_batched=True)
    for leaf in ("f", "P", "X", "rho"):
        assert torch.equal(getattr(bcast.alloc, leaf), getattr(stacked.alloc, leaf)), leaf


def test_mixed_tenant_rows_are_bitforbit_as_if_alone():
    """Two tenants with different A(rho) fits co-batched in one flush: each
    row solves and scores as if it were alone under its own fit."""
    fits = [bridge.accuracy_from_numpy(ab, device="cpu")
            for ab in ({"a": 0.6356, "b": 0.4025}, {"a": 0.9, "b": 0.2})]
    requests = _port_requests(((3, 8), (4, 8)))
    svc = AllocService(SERVE, device="cpu")
    for t, acc in enumerate(fits):
        svc.set_accuracy(acc, tenant=t)
    for t, p in enumerate(requests):
        svc.submit(p, tenant=t)
    together = {c.req_id: c for c in svc.drain(now=0.0)[0]}
    assert svc.metrics.batches == 1
    for t, p in enumerate(requests):
        alone = _answers(AllocService(SERVE, svc.executables, device="cpu"), [p], accuracy=fits[t])[0]
        c = together[t]
        for leaf in ("f", "P", "X", "rho"):
            assert torch.equal(getattr(c.alloc, leaf), getattr(alone.alloc, leaf)), (t, leaf)
        assert c.objective == alone.objective


def test_exact_mode_canonicalises_b_ulp_split():
    """Two equal-bbar requests whose B differ by one ulp (built with
    `math.nextafter`, as float round-trips produce them) share one bucket
    key in exact-shape mode and flush together."""
    b = 400e3 * 12
    b_up = math.nextafter(b, math.inf)
    assert b_up != b
    pa, pb = (both_params(*numpy_scenarios(s, N=4, K=12, B=B))[1] for s, B in ((0, b), (1, b_up)))
    svc = AllocService(SERVE._replace(buckets=None), device="cpu")
    assert svc._bucket_key(svc._pad(pa)) == svc._bucket_key(svc._pad(pb))
    svc.submit(pa, now=0.0)
    svc.submit(pb, now=0.0)
    done, _ = svc.flush_full(now=0.0)           # max_batch 2: fires only co-queued
    assert len(done) == 2
    for c, p in zip(done, (pa, pb)):
        assert c.alloc.P.shape == (4, 12) and bool(feasible(p, c.alloc))


def test_program_count_is_bounded():
    """A warm service with ``top_k=2`` holds one cold solver per bucket and
    at most two refine programs (one candidate; ``top_k`` candidates) however
    its flushes mix hits and misses."""
    cfg = SERVE._replace(warmstart=WarmStartConfig(top_k=2))
    requests = _port_requests(((3, 8), (3, 8)))
    svc = AllocService(cfg, device="cpu")
    for rounds in ([requests[0]], requests, requests):
        _answers(svc, rounds)
    keys = list(svc.executables)
    assert len([k for k in keys if "warm-refine" not in k]) == 1
    refine = [k for k in keys if "warm-refine" in k]
    assert 1 <= len(refine) <= 2 and {k[-1] for k in refine} <= {1, 2}
    assert svc.metrics.cache_misses == len(keys)


@pytest.mark.parametrize("cap,n", [(4096, 50), (16, 500), (1, 40)])
def test_reservoir_samples_equal_the_references(cap, n):
    """Same seed, same stream: the same retained sample, count, mean, max
    and percentiles as the reference's reservoir."""
    xs = np.random.default_rng(cap).standard_normal(n).tolist()
    got, want = Reservoir(cap, seed=3), JReservoir(cap, seed=3)
    for x in xs:
        got.add(x)
        want.add(x)
    assert got.sample == want.sample
    assert (got.count, got.mean(), got.max()) == (want.count, want.mean(), want.max())
    for q in (50.0, 95.0):
        assert got.percentile(q) == want.percentile(q) == percentile(got, q)
