"""The port's warm starts (`repro_torch.core.allocator`: `ExtraStart`,
`refine_with_start`; `repro_torch.serve.warmstart`) against the JAX
reference, on the CPU, plus the rows the port proves about itself.

Held to the reference: a refined batch's hardened X, the cache's signature
tuple (computed from host floats, so a hit in one package is a hit in the
other), its LRU order, statistics and top-k lookup order, `batch_starts`,
`pad_start` and `iters_to_converge` value for value. Inside the port: an
invalid start (single and top-k) returns the cold result bit for bit, a
mixed hit/miss batch leaves its misses bit for bit cold, a (B, 1) candidate
axis is the (B,) layout bit for bit, a padded-bucket hit equals the
exact-shape hit, and dominance (warm objective <= cold + float32
round-off) holds for garbage, stale and wrong-scenario entries on a few
hypothesis examples. Scenarios are numpy draws handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import AllocatorConfig as JConfig, Weights as JWeights
from repro.core import pad_params as jpad, solve_batch as jsolve_batch
from repro.core.accuracy import AccuracyFn as JAccuracyFn
from repro.core.allocator import ExtraStart as JExtraStart
from repro.core.pgd import PGDConfig as JPGD
from repro.serve import warmstart as jws
from repro_torch import bridge
from repro_torch.core import (
    AllocatorConfig, ExtraStart, Weights, default_accuracy, refine_with_start, solve,
    solve_batch, stack_params, tree_index,
)
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.system import objective
from repro_torch.core.types import ShapeBucket, pad_params
from repro_torch.serve import (
    AllocService, BatchPolicy, CacheEntry, ServeConfig, WarmStartCache, WarmStartConfig,
    batch_starts, entry_from_alloc, iters_to_converge, pad_start, request_signature,
)
from repro_torch.serve import warmstart as tws
from torch_port_util import both_params, np_, numpy_scenarios

torch.set_num_threads(1)

#: the reference's warm-start test config (tests/test_warmstart.py:TINY)
TINY = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=40))
JTINY = JConfig(inner="pgd", outer_iters=2, pgd=JPGD(steps=40))
CFG_COLD = ServeConfig(policy=BatchPolicy(max_batch=2, max_wait_s=0.01), allocator=TINY)
CFG_WARM = CFG_COLD._replace(warmstart=WarmStartConfig())
PROP_N, PROP_K = 3, 6
W = Weights.ones()


def _scen(seed, n=PROP_N, k=PROP_K, batch=None):
    """(reference params, port params) of one numpy draw."""
    return both_params(*numpy_scenarios(seed, N=n, K=k, batch=batch, B=400e3 * k))


def _cold(tp):
    return solve_batch(stack_params([tp]), W, TINY)


def _obj(tp, alloc) -> float:
    return float(objective(tp, W, alloc))


def _tol(cold_obj: float) -> float:
    """float32 round-off, additive on max(1, |cold|) (objectives are O(1)
    and may be negative): the reference's warm-start tolerance."""
    return 1e-5 * max(1.0, abs(cold_obj))


def _assert_hardened(X):
    X = np_(X)
    assert set(np.unique(X)) <= {0.0, 1.0}
    assert (X.sum(axis=0) == 1.0).all() and (X.sum(axis=1) >= 1.0).all()


def _assert_same_result(a, b):
    for leaf in ("f", "P", "X", "rho"):
        assert torch.equal(getattr(a.alloc, leaf), getattr(b.alloc, leaf)), leaf
    assert torch.equal(a.trace, b.trace)


# ---------------------------------------------------------------------------
# the allocator layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["single", "topk"])
def test_invalid_start_is_bitforbit_cold(layout):
    """valid = 0 rows pass the cold result through bit for bit, every leaf
    and the trace: selection is a gather over [base] + masked candidates."""
    _, tp = _scen(4, batch=2)
    base = solve_batch(tp, W, TINY)
    C = () if layout == "single" else (2,)
    garbage = ExtraStart(
        f=np.full((2,) + C + (PROP_N,), np.inf, np.float32),
        P=np.ones((2,) + C + (PROP_N, PROP_K), np.float32),
        X=np.ones((2,) + C + (PROP_N, PROP_K), np.float32),
        valid=np.zeros((2,) + C, np.float32),
    )
    _assert_same_result(base, solve_batch(tp, W, TINY, extra_starts=garbage))


def test_mixed_hit_miss_batch_isolated():
    """In one batch a warm row does not perturb the cold rows: the miss rows
    of a mixed batch equal the all-cold batch bit for bit, and the hit row
    dominates its cold answer."""
    _, tp = _scen(1, batch=3)
    base = solve_batch(tp, W, TINY)
    donor = _cold(_scen(7)[1]).alloc
    extra = ExtraStart(*(torch.cat([getattr(donor, k)] * 3) for k in ("f", "P", "X")),
                       valid=np.asarray([1.0, 0.0, 0.0], np.float32))
    mixed = solve_batch(tp, W, TINY, extra_starts=extra)
    for i in (1, 2):
        _assert_same_result(tree_index(base, i), tree_index(mixed, i))
    cold0 = _obj(tree_index(tp, 0), tree_index(base.alloc, 0))
    assert _obj(tree_index(tp, 0), tree_index(mixed.alloc, 0)) <= cold0 + _tol(cold0)


def test_single_candidate_axis_is_bitforbit_legacy():
    """A (B, 1) candidate axis is the (B,) layout, bit for bit."""
    _, tp = _scen(21)
    donor = _cold(tp).alloc
    f, P, X = (getattr(donor, k) for k in ("f", "P", "X"))
    legacy = solve_batch(stack_params([tp]), W, TINY,
                         extra_starts=ExtraStart(f, P, X, np.ones(1, np.float32)))
    multi = solve_batch(stack_params([tp]), W, TINY,
                        extra_starts=ExtraStart(f[:, None], P[:, None], X[:, None],
                                                np.ones((1, 1), np.float32)))
    _assert_same_result(legacy, multi)


def test_extra_starts_and_solve_extra_start():
    """`solve_batch(extra_starts=)` validates valid's shape with the
    reference's message; `solve(extra_start=)` is `solve_batch` on a batch of
    one, bit for bit."""
    _, tp = _scen(0)
    with pytest.raises(ValueError, match=r"extra_starts\.valid"):
        solve_batch(stack_params([tp]), W, TINY, extra_starts=ExtraStart(
            np.zeros((1, PROP_N), np.float32), np.zeros((1, PROP_N, PROP_K), np.float32),
            np.zeros((1, PROP_N, PROP_K), np.float32), np.zeros((2,), np.float32)))
    donor = _cold(_scen(9)[1]).alloc
    one = solve(tp, W, TINY, extra_start=ExtraStart(donor.f[0], donor.P[0], donor.X[0], 1.0))
    batch = solve_batch(stack_params([tp]), W, TINY, extra_starts=ExtraStart(
        donor.f, donor.P, donor.X, np.ones(1, np.float32)))
    _assert_same_result(one, tree_index(batch, 0))


@pytest.mark.parametrize("layout", ["single", "topk"])
def test_refined_x_equals_the_references(layout):
    """The same numpy scenarios and donor solutions through the reference's
    refine pass (`solve_batch(extra_starts=)`, its vmapped
    `refine_with_start`) and the port's `refine_with_start` on the port's
    cold result: the same hardened X. The port's `solve_batch` with the same
    starts is its `refine_with_start`, bit for bit."""
    jp, tp = _scen(3, batch=2)
    donors = [jsolve_batch(_scen(s, batch=2)[0], JWeights.ones(), JTINY).alloc for s in (11, 12)]
    C = 1 if layout == "single" else 2
    leaves = {k: np.stack([np.asarray(getattr(d, k)) for d in donors[:C]], axis=1)
              for k in ("f", "P", "X")}
    valid = np.asarray([[1.0] * C, [0.0] + [1.0] * (C - 1)], np.float32)
    if layout == "single":
        leaves, valid = {k: v[:, 0] for k, v in leaves.items()}, valid[:, 0]
    want = jsolve_batch(jp, JWeights.ones(), JTINY, extra_starts=JExtraStart(**leaves, valid=valid))
    extra = ExtraStart(**leaves, valid=valid)
    base = solve_batch(tp, W, TINY)
    got = refine_with_start(tp, W, TINY, default_accuracy(), extra, base)
    np.testing.assert_array_equal(np_(got.alloc.X), np.asarray(want.alloc.X))
    _assert_same_result(got, solve_batch(tp, W, TINY, extra_starts=extra))


@pytest.mark.parametrize("entry_mode", ["wrong_scenario", "stale", "garbage", "scaled"])
@settings(max_examples=1, deadline=None)
@given(
    scenario_seed=st.integers(min_value=0, max_value=10_000),
    entry_seed=st.integers(min_value=0, max_value=10_000),
    scale=st.floats(min_value=0.0, max_value=1e6),
    topk=st.booleans(),
)
def test_warm_dominance_property(entry_mode, scenario_seed, entry_seed, scale, topk):
    """For a scenario and an entry that is another scenario's solution, one
    solved under a stale A(rho) fit, garbage (non-finite or huge) or a
    mis-scaled prior, alone or beside the row's own solution as a top-k
    candidate list, the warm objective is <= the cold one + float32
    round-off and the answer is a hardened allocation."""
    _, tp = _scen(scenario_seed)
    base = _cold(tp)
    cold_obj = _obj(tp, tree_index(base.alloc, 0))
    own = [getattr(base.alloc, k)[0] for k in ("f", "P", "X")]
    rng = np.random.default_rng(entry_seed)
    if entry_mode == "wrong_scenario":
        entry = [getattr(_cold(_scen(entry_seed + 20_000)[1]).alloc, k)[0] for k in ("f", "P", "X")]
    elif entry_mode == "stale":
        stale_acc = bridge.accuracy_from_numpy({"a": 0.58, "b": 0.44}, device="cpu")
        old = solve_batch(stack_params([tp]), W, TINY, stale_acc).alloc
        entry = [getattr(old, k)[0] for k in ("f", "P", "X")]
    elif entry_mode == "garbage":
        bad = rng.choice([np.nan, np.inf, -np.inf, 1e30, -5.0])
        entry = [np.full((PROP_N,), bad), rng.standard_normal((PROP_N, PROP_K)) * 1e12,
                 np.full((PROP_N, PROP_K), bad)]
    else:
        entry = [own[0] * scale, own[1] * scale, own[2]]
    cands = [own, entry] if topk else [entry]
    extra = ExtraStart(
        *(torch.stack([torch.as_tensor(np.asarray(c[i], np.float32)) for c in cands])[None]
          for i in range(3)),
        valid=np.ones((1, len(cands)), np.float32),
    )
    warm = tree_index(solve_batch(stack_params([tp]), W, TINY, extra_starts=extra).alloc, 0)
    warm_obj = _obj(tp, warm)
    assert warm_obj <= cold_obj + _tol(cold_obj), (entry_mode, topk, warm_obj, cold_obj)
    _assert_hardened(warm.X)


# ---------------------------------------------------------------------------
# the cache: signatures, LRU, lookup, starts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,k", [(0, 3, 6), (5, 4, 12), (8, 6, 16)])
def test_request_signature_equals_the_references(seed, n, k):
    """The same numpy scenario, weights and fit give the reference's
    signature tuple exactly, and both packages collide on a 1% channel
    perturbation and split on a 1e4 one."""
    jp, tp = _scen(seed, n, k)
    kap = {"kappa1": 1.0, "kappa2": 2.5, "kappa3": 0.3}
    tw = bridge.weights_from_numpy(kap, device="cpu")
    jw = JWeights(*(jnp.float32(v) for v in kap.values()))
    tacc = bridge.accuracy_from_numpy({"a": 0.6356, "b": 0.4025}, device="cpu")
    jacc = JAccuracyFn(jnp.float32(0.6356), jnp.float32(0.4025))
    for cfg in (WarmStartConfig(), WarmStartConfig(gain_quant_db=3.0, acc_digits=1)):
        jcfg = jws.WarmStartConfig(**cfg._asdict())
        sig = request_signature(tp, tw, tacc, cfg)
        assert sig == jws.request_signature(jp, jw, jacc, jcfg)
        for factor in (1.01, 1e4):
            arrays, meta = numpy_scenarios(seed, N=n, K=k, B=400e3 * k)
            arrays["g"] = (arrays["g"] * np.float32(factor)).astype(np.float32)
            jq, tq = both_params(arrays, meta)
            moved = request_signature(tq, tw, tacc, cfg)
            assert moved == jws.request_signature(jq, jw, jacc, jcfg)
            assert (moved == sig) == (factor == 1.01)


def _sig(gains: tuple, acc=(0.5, 0.5)) -> tuple:
    """A signature in `request_signature`'s layout: 7 exact components,
    the quantized gain steps at index 7, then the fit and the weights."""
    return (3, 6, 1.0, 2.0, 3.0, 4.0, 5.0, gains, acc, (1.0, 1.0, 1.0))


def test_cache_lru_stats_and_lookup_match_the_references():
    """One script of puts, gets and top-k lookups on both caches: the same
    entries come back in the same order, evictions follow the same LRU
    order (neighbour reads do not refresh recency) and the statistics
    agree."""
    script = [
        ("put", (0, 0, 0), 0.1), ("put", (1, 0, 0), 0.2), ("put", (3, -2, 0), 0.3),
        ("lookup", (0, 0, 0), 3), ("get", (1, 0, 0)), ("put", (5, 5, 5), 0.4),
        ("lookup", (0, 0, 0), 2), ("get", (3, -2, 0)), ("lookup", (9, 9, 9), 3),
        ("put", (0, 0, 1), 0.5), ("lookup", (0, 0, 0), 1), ("get", (7, 7, 7)),
        ("lookup", (0, 0, 2), 3), ("put", (0, 0, 0), 0.6), ("lookup", (0, 0, 1), 3),
    ]
    caches = [(WarmStartCache(WarmStartConfig(capacity=3, top_k=3)), CacheEntry),
              (jws.WarmStartCache(jws.WarmStartConfig(capacity=3, top_k=3)), jws.CacheEntry)]
    seen = []
    for cache, Entry in caches:
        out = []
        for op, gains, *arg in script:
            if op == "put":
                fill = arg[0]
                cache.put(_sig(gains), Entry(np.full(3, fill, np.float32),
                                             np.full((3, 6), fill, np.float32),
                                             np.zeros((3, 6), np.float32), 0.0))
            elif op == "get":
                e = cache.get(_sig(gains))
                out.append(None if e is None else float(e.f[0]))
            else:
                out.append([float(e.f[0]) for e in cache.lookup(_sig(gains), arg[0])])
        seen.append((out, cache.stats(), len(cache)))
    assert seen[0] == seen[1]
    assert seen[0][1]["warm_cache_evictions"] > 0


def test_batch_starts_and_pad_start_match_the_references():
    """`pad_start` and `batch_starts` (the (B,) layout, the (B, C) top-k
    layout padded to k, all misses -> None) give the reference's arrays and
    masks value for value; padded rows and columns stay 0."""
    jp, tp = _scen(5)
    jpp, tpp = jpad(jp, PROP_N + 2, PROP_K + 3), pad_params(tp, ShapeBucket(PROP_N + 2, PROP_K + 3))
    entry = lambda mod, fill: mod.CacheEntry(np.full((PROP_N,), fill, np.float32),
                                             np.full((PROP_N, PROP_K), fill, np.float32),
                                             np.eye(PROP_N, PROP_K, dtype=np.float32), 0.0)
    f, P, X = pad_start(entry(tws, 0.25), tpp)
    assert f.shape == (PROP_N + 2,) and P.shape == X.shape == (PROP_N + 2, PROP_K + 3)
    assert not P[PROP_N:].any() and not P[:, PROP_K:].any()
    for got, want in zip((f, P, X), jws.pad_start(entry(jws, 0.25), jpp)):
        np.testing.assert_array_equal(got, want)
    def entries(mod, per_slot, k):
        """Per slot: None (a miss), a bare entry, or a candidate list."""
        return [None if fills is None else entry(mod, fills[0]) if k is None
                else [entry(mod, x) for x in fills] for fills in per_slot]

    for per_slot, k in ((([0.2], None), None), (([0.2, 0.4], None), 3), ((None, None), None)):
        got = batch_starts(entries(tws, per_slot, k), [tpp] * 2, k=k)
        want = jws.batch_starts(entries(jws, per_slot, k), [jpp] * 2, k=k)
        if want is None:
            assert got is None
            continue
        assert np.shape(got.valid) == ((2,) if k is None else (2, k))
        for leaf in ("f", "P", "X", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(got, leaf)),
                                          np.asarray(getattr(want, leaf)))


@pytest.mark.parametrize("trace", [[5.0, 2.0, 1.0, 1.0], [1.0, 1.0, 1.0], [3.0, np.nan, 2.0],
                                   [np.inf, 1.0], [2.0, 1.0, np.nan], [-2.0, -2.0005, -2.0007]])
def test_iters_to_converge_equals_the_references(trace):
    assert iters_to_converge(torch.tensor(trace), 1e-3) == jws.iters_to_converge(trace, 1e-3)


# ---------------------------------------------------------------------------
# the service layer
# ---------------------------------------------------------------------------


def test_service_empty_cache_is_bitforbit_disabled():
    """Every request of one drained batch misses (nothing was completed
    yet), so the warm service answers bit for bit like a warmstart=None
    service."""
    requests = [_scen(s, *nk)[1] for s, nk in zip((7, 8, 9), ((3, 8), (4, 8), (3, 8)))]
    cold_svc = AllocService(CFG_COLD, device="cpu")
    warm_svc = AllocService(CFG_WARM, executables=cold_svc.executables, device="cpu")
    done = []
    for svc in (cold_svc, warm_svc):
        for p in requests:
            svc.submit(p)
        done.append({c.req_id: c for c in svc.drain(now=0.0)[0]})
    assert warm_svc.warm_cache.stats()["warm_cache_hits"] == 0
    for i, c in done[1].items():
        assert not c.warm_hit and c.warm_start is None
        for leaf in ("f", "P", "X", "rho"):
            assert torch.equal(getattr(c.alloc, leaf), getattr(done[0][i].alloc, leaf))


def test_service_records_reuses_and_pads_hits_like_exact_ones():
    """The second identical request hits the entry the first flush recorded
    and dominates; the same entry attached at the exact shape and padded
    into a bucket gives the same hardened X."""
    params = _scen(11, 3, 8)[1]
    svc = AllocService(CFG_WARM, device="cpu")
    svc.submit(params)
    first, _ = svc.drain(now=0.0)
    assert svc.warm_cache.stats()["warm_cache_puts"] == 1
    svc.submit(params)
    second, _ = svc.drain(now=1.0)
    assert second[0].warm_hit
    assert second[0].objective <= first[0].objective + _tol(first[0].objective)

    entry = entry_from_alloc(tree_index(_cold(_scen(99, 3, 8)[1]).alloc, 0))
    xs = []
    for buckets in (None, (ShapeBucket(6, 12),)):
        s = AllocService(CFG_WARM._replace(buckets=buckets), device="cpu")
        s.submit(params, warm_start=entry)
        (c,), _ = s.drain(now=0.0)
        assert c.warm_hit
        xs.append(c.alloc.X)
    assert torch.equal(*xs)
