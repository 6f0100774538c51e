"""The port's real-clock driver, asyncio face, learned ladder and serving
CLI (`repro_torch.serve.{driver,aio,ladder}`, `repro_torch.launch.serve_alloc`)
on the CPU.

Held to the reference: `learn_buckets`, `padded_area_waste` and
`LadderLearner` give the reference's ladders, wastes and errors on the same
histograms (both packages keep their own copy of the plain-Python
algorithm). Inside the port: the real-clock driver answers every request
with the hardened X of its virtual-clock replay, exactly (alone, under
threaded submitters, across a manual refit and an auto-refit on shape-mix
drift, and through `AsyncAllocDriver`); close drains, is idempotent and
fences submit; a solver error fails the in-flight futures; the bounded
admission queue rejects, times out and resumes. No assertion reads a
latency: answers, not timing.
"""
import asyncio
import os
import subprocess
import sys
import threading

import pytest
import torch

from repro.serve import ladder as jladder
from repro_torch.core import AllocatorConfig, sample_params, sample_request_stream
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.types import DEFAULT_BUCKETS
from repro_torch.serve import (
    AdmissionQueueFull, AllocService, AsyncAllocDriver, BatchPolicy, DriverClosed,
    DriverConfig, LadderLearner, RealClockDriver, ServeConfig, learn_buckets,
    pace_stream, padded_area_waste, run_load, same_hardened_assignments,
)

torch.set_num_threads(1)

#: generous wall-clock allowance for one batched solve on a loaded box
WAIT_S = 120.0
#: the reference's driver test config (tests/test_serve_driver.py:CFG)
TINY = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=40))
CFG = ServeConfig(policy=BatchPolicy(max_batch=2, max_wait_s=0.01), allocator=TINY)


def _stream(n=6, seed=7, sizes=((3, 8), (4, 8))):
    return sample_request_stream(seed, n, sizes=sizes, device="cpu")


def _replay(service, requests):
    """The same requests through `run_load` on a fresh service with the
    default ladder, sharing the solver cache."""
    fresh = AllocService(service.cfg._replace(buckets=DEFAULT_BUCKETS),
                         executables=service.executables, device="cpu")
    return run_load(fresh, requests, [0.0] * len(requests)).completions


# ---------------------------------------------------------------------------
# real clock == virtual clock
# ---------------------------------------------------------------------------


def test_driver_matches_virtual_replay_exact_x():
    """Paced arrivals through the real-clock driver and the same stream on
    the virtual clock: the same req_id -> hardened X, exact shapes back."""
    requests = _stream()
    service = AllocService(CFG, device="cpu")
    service.warmup(requests)
    driver = RealClockDriver(service)
    futures, _ = pace_stream(driver, requests, [0.002 * i for i in range(len(requests))])
    driver.close(timeout=WAIT_S)
    done = [f.result(timeout=0.0) for f in futures]
    assert sorted(c.req_id for c in done) == list(range(len(requests)))
    for c in done:
        assert c.alloc.P.shape == (requests[c.req_id].N, requests[c.req_id].K)
    assert same_hardened_assignments(done, _replay(service, requests))


def test_multithreaded_submitters_all_answered_exactly():
    """Eight caller threads (more than the cores the tests get) with a
    shortened interpreter switch interval: every request is answered, with
    its own scenario's exact X (a lost or crossed update would break it)."""
    requests = _stream(8)
    service = AllocService(CFG, device="cpu")
    results: dict[int, object] = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with RealClockDriver(service) as driver:
            def client(i):
                results[i] = driver.submit(requests[i]).result(timeout=WAIT_S)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(8))
    # submission order across threads is arbitrary: map req_id -> request
    by_req = {c.req_id: requests[i] for i, c in results.items()}
    replay = run_load(AllocService(CFG, service.executables, device="cpu"),
                      [by_req[r] for r in range(8)], [0.0] * 8).completions
    assert same_hardened_assignments(list(results.values()), replay)


def test_async_driver_equals_the_sync_driver():
    """`AsyncAllocDriver` answers request for request like the threaded
    driver it wraps."""
    requests = _stream(4, seed=9)
    service = AllocService(CFG, device="cpu")

    async def serve():
        async with AsyncAllocDriver(service) as facade:
            return await asyncio.gather(*(facade.submit(p) for p in requests))

    done = asyncio.run(serve())
    assert [c.alloc.P.shape for c in done] == [(p.N, p.K) for p in requests]
    with RealClockDriver(AllocService(CFG, service.executables, device="cpu")) as driver:
        sync = [driver.submit(p).result(timeout=WAIT_S) for p in requests]
    # request ids follow admission order, which the executor threads race
    # for: compare request by request
    for a, b in zip(done, sync):
        assert torch.equal(a.alloc.X, b.alloc.X) and torch.equal(a.alloc.P, b.alloc.P)


# ---------------------------------------------------------------------------
# shutdown and failure
# ---------------------------------------------------------------------------


def test_close_drains_pending_requests():
    """Requests in never-full, never-due buckets are answered by the drain."""
    requests = _stream(3)
    cfg = CFG._replace(policy=BatchPolicy(max_batch=8, max_wait_s=1e6))
    service = AllocService(cfg, device="cpu")
    driver = RealClockDriver(service, DriverConfig(completion_log=2))
    futures = [driver.submit(p) for p in requests]
    driver.close(timeout=WAIT_S)
    done = [f.result(timeout=0.0) for f in futures]
    assert sorted(c.req_id for c in done) == [0, 1, 2]
    assert service.pending() == 0
    assert len(driver.completions) == 2          # the log is bounded


def test_close_is_idempotent_and_fences_submit():
    driver = RealClockDriver(AllocService(CFG, device="cpu"))
    driver.close(timeout=WAIT_S)
    driver.close(timeout=WAIT_S)
    with pytest.raises(DriverClosed):
        driver.submit(sample_params(0, N=4, K=8, device="cpu"))


def test_solver_thread_error_fails_futures_and_close_raises():
    service = AllocService(CFG, device="cpu")

    def boom(now):
        raise RuntimeError("synthetic flush failure")

    service.flush_due = boom
    driver = RealClockDriver(service)
    fut = driver.submit(sample_params(0, N=4, K=8, device="cpu"))
    with pytest.raises(RuntimeError, match="synthetic flush failure"):
        fut.result(timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="solver thread died"):
        driver.close(timeout=WAIT_S)


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------


def test_backpressure_rejects_when_full():
    p = sample_params(0, N=4, K=8, device="cpu")
    driver = RealClockDriver(AllocService(CFG, device="cpu"),
                             DriverConfig(queue_capacity=2, block=False), start=False)
    driver.submit(p)
    driver.submit(p)
    with pytest.raises(AdmissionQueueFull):
        driver.submit(p)
    driver.close()                  # the queued requests are served inline
    assert len(driver.completions) == 2


def test_backpressure_block_times_out():
    p = sample_params(0, N=4, K=8, device="cpu")
    driver = RealClockDriver(
        AllocService(CFG, device="cpu"),
        DriverConfig(queue_capacity=1, block=True, submit_timeout_s=0.05), start=False,
    )
    driver.submit(p)
    with pytest.raises(AdmissionQueueFull):
        driver.submit(p)
    driver.close()
    assert len(driver.completions) == 1


def test_backpressure_blocking_submit_resumes():
    requests = _stream(2)
    driver = RealClockDriver(AllocService(CFG, device="cpu"),
                             DriverConfig(queue_capacity=1, block=True), start=False)
    futures = [driver.submit(requests[0])]
    unblocked = threading.Event()

    def second():
        futures.append(driver.submit(requests[1]))       # parks on the bound
        unblocked.set()

    t = threading.Thread(target=second)
    t.start()
    assert not unblocked.wait(timeout=0.1)
    driver.start()
    assert unblocked.wait(timeout=WAIT_S)
    t.join(timeout=WAIT_S)
    driver.close(timeout=WAIT_S)
    assert not t.is_alive() and len(driver.completions) == 2


# ---------------------------------------------------------------------------
# the learned ladder
# ---------------------------------------------------------------------------

MIXES = [
    ({(4, 12): 50, (4, 16): 30, (8, 16): 20}, 4, ()),
    ({(2, 4): 10, (3, 9): 5, (4, 16): 2, (6, 24): 1, (8, 32): 1}, 2, ()),
    ({(4, 12): 1000, (7, 29): 1}, 2, ()),
    ({(3, 8): 6, (4, 8): 2, (10, 50): 3, (6, 16): 5}, 3, [(64, 256)]),
    ({(100, 400): 1, (10, 50): 40}, 7, ()),
]


@pytest.mark.parametrize("mix,budget,must_fit", MIXES)
def test_learn_buckets_equals_the_references(mix, budget, must_fit):
    got = learn_buckets(mix, budget, must_fit=must_fit)
    want = jladder.learn_buckets(mix, budget, must_fit=must_fit)
    assert [tuple(b) for b in got] == [tuple(b) for b in want]
    assert padded_area_waste(mix, got) == jladder.padded_area_waste(mix, want)
    # the default ladder's waste (inf where it cannot serve the mix)
    assert LadderLearner._waste_or_inf(mix, DEFAULT_BUCKETS) == \
        jladder.LadderLearner._waste_or_inf(mix, jladder.DEFAULT_BUCKETS)


@pytest.mark.parametrize("bad", [({}, {}), ({(8, 4): 1}, {}), ({(4, 8): 1}, {"max_buckets": 0}),
                                 ({(2, 4): 5}, {"must_fit": [(8, 4)]})])
def test_learn_buckets_errors_equal_the_references(bad):
    mix, kw = bad
    with pytest.raises(ValueError) as got:
        learn_buckets(mix, **kw)
    with pytest.raises(ValueError) as want:
        jladder.learn_buckets(mix, **kw)
    assert str(got.value) == str(want.value)


def test_ladder_learner_snapshots_equal_the_references():
    """Below ``min_samples``, above it, and beyond the fallback ladder (its
    waste inf): the same snapshots in both packages."""
    learners = (LadderLearner(min_samples=5), jladder.LadderLearner(min_samples=5))
    snaps = ([], [])
    for obs in ([(4, 12, 3)], [(8, 16, 4)], [(100, 400, 1)]):
        for learner, out in zip(learners, snaps):
            for n, k, c in obs:
                learner.observe(n, k, count=c)
            s = learner.refit(must_fit=[(2, 2)])
            out.append(([tuple(b) for b in s.buckets], s.waste, s.baseline_waste, s.n_observed))
    assert snaps[0] == snaps[1]
    assert snaps[0][0][0] == [tuple(b) for b in DEFAULT_BUCKETS]
    assert snaps[0][2][2] == float("inf")


def test_driver_refit_mid_stream_keeps_every_answer():
    """A manual refit between two halves of a stream: the second half pads
    into the learned ladder, the ladder keeps the old cover shape, and
    every answer equals the virtual replay's."""
    requests = _stream(4)
    service = AllocService(CFG, device="cpu")
    with RealClockDriver(service, ladder=LadderLearner(min_samples=1)) as driver:
        first = [driver.submit(p).result(timeout=WAIT_S) for p in requests[:2]]
        snap = driver.refit()
        assert service.cfg.buckets == snap.buckets != DEFAULT_BUCKETS
        assert any(b.fits(64, 256) for b in snap.buckets)
        second = [driver.submit(p).result(timeout=WAIT_S) for p in requests[2:]]
    assert all(c.bucket in {(b.N, b.K) for b in snap.buckets} for c in second)
    assert same_hardened_assignments(first + second, _replay(service, requests))


def test_driver_auto_refit_on_drift_keeps_every_answer():
    """With a waste threshold the solver thread refits on its own when the
    observed mix drifts, and every answer still equals the virtual replay's
    (padding is answer-transparent)."""
    requests = _stream(8, sizes=((3, 8), (4, 8), (4, 8), (4, 8)))
    service = AllocService(CFG, device="cpu")
    driver = RealClockDriver(
        service,
        cfg=DriverConfig(refit_waste_threshold=0.01, refit_check_every=4, refit_min_samples=4),
        ladder=LadderLearner(min_samples=1),
    )
    with driver:
        done = [f.result(timeout=WAIT_S) for f in [driver.submit(p) for p in requests]]
    assert driver.auto_refits >= 1 and service.cfg.buckets != DEFAULT_BUCKETS
    assert padded_area_waste([(p.N, p.K) for p in requests], service.cfg.buckets) == 0.0
    assert same_hardened_assignments(done, _replay(service, requests))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--scenario", "gauss_markov", "--warmstart"]],
                         ids=["iid", "gauss_markov-warmstart"])
def test_serve_alloc_cli_real_driver_smoke(extra):
    """``--driver real --smoke --device cpu`` serves the stream, replays it
    on the virtual clock and exits 0 only if every req_id -> X agrees."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_alloc", "--driver", "real", "--smoke",
         "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "real-vs-virtual equivalence (exact hardened X, 8 reqs): True" in out.stdout
    assert "served 8/8 requests (8 feasible)" in out.stdout
