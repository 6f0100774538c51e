"""Scenario sharding in the port (`repro_torch.core.distribute`): a sharded
`solve_batch` returns the single-device hardened X, batches the mesh size
does not divide are padded and sliced back, and the sharded service
(``ServeConfig.shard_batch``) sizes its slots by the mesh and answers as
the unsharded one. The port counterparts of `tests/test_distribute.py`.

The mesh is four ``torch.device("cpu")`` entries, so the batch really
splits into four chunks solved one after another. Tolerances (the
reference's own, `tests/test_distribute.py`): hardened X exactly; rho to
rtol 5e-3 and each scenario's objective to rtol 1e-2, since the solver
amplifies the last-bit differences a chunk's other batch size makes in the
CPU's vectorised elementwise functions.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    AllocatorConfig, ExtraStart, Weights, pad_batch, scenario_mesh, shard_batch,
    slice_batch, solve_batch, stack_params, stack_weights, tree_index,
)
from repro_torch.core.distribute import gather_batch, round_up
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.system import feasible, objective
from repro_torch.scenarios import get_family
from repro_torch.serve import AllocService, BatchPolicy, ServeConfig

torch.set_num_threads(1)

W = Weights.ones()
CFG = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=60))
MESH = scenario_mesh(["cpu"] * 4)
FAMILY = get_family("iid_rayleigh")


def _batch(seed, b, N=4, K=8):
    return FAMILY.sample_batch(seed, b, N=N, K=K, device="cpu")


def _assert_batches_equivalent(params_batch, got, ref, weights=None):
    """Exact hardened X; rho and per-scenario objective to the reference's
    tolerances."""
    assert torch.equal(got.alloc.X, ref.alloc.X)
    np.testing.assert_allclose(got.alloc.rho.numpy(), ref.alloc.rho.numpy(), rtol=5e-3)
    for i in range(got.alloc.rho.shape[0]):
        p = tree_index(params_batch, i)
        w = tree_index(weights, i) if weights is not None else W
        np.testing.assert_allclose(float(objective(p, w, tree_index(got.alloc, i))),
                                   float(objective(p, w, tree_index(ref.alloc, i))), rtol=1e-2)


def test_scenario_mesh_checks_its_devices():
    assert MESH == (torch.device("cpu"),) * 4
    if not torch.cuda.is_available():            # the default mesh is every card
        with pytest.raises(RuntimeError, match="CUDA"):
            scenario_mesh()
    for bad in (object(), "cpu", [], [1, 2]):
        with pytest.raises((TypeError, ValueError)):
            scenario_mesh(bad)


def test_shard_batch_splits_leading_axis():
    """One chunk per device, whole on the trailing axes; numpy leaves (a
    warm start's) stay numpy; `gather_batch` undoes it."""
    pb = _batch(0, len(MESH) * 2)
    chunks = shard_batch(pb, MESH)
    assert [c.g.shape for c in chunks] == [(2, 4, 8)] * 4
    assert all(c.N == 4 and c.K == 8 for c in chunks)
    back = gather_batch(chunks, "cpu")
    assert torch.equal(back.g, pb.g) and torch.equal(back.sc_mask, pb.sc_mask)
    extra = ExtraStart(np.zeros((8, 4)), np.zeros((8, 4, 8)), np.zeros((8, 4, 8)), np.ones(8))
    assert all(isinstance(c.P, np.ndarray) and c.P.shape == (2, 4, 8) for c in shard_batch(extra, MESH))
    with pytest.raises(ValueError, match="multiple"):
        shard_batch(_batch(1, 3), MESH)


def test_pad_slice_batch_roundtrip():
    pb = _batch(1, 3)
    padded = pad_batch(pb, 8)
    assert padded.g.shape == (8, 4, 8) and round_up(3, 4) == 4
    # tail replicas of the last scenario, real block untouched
    assert torch.equal(padded.g[:3], pb.g) and torch.equal(padded.g[7], pb.g[2])
    assert torch.equal(slice_batch(padded, 3).g, pb.g)
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    assert np.array_equal(pad_batch(ExtraStart(valid, valid, valid, valid), 5).valid,
                          [1.0, 0.0, 1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="shrink"):
        pad_batch(pb, 2)


def test_sharded_solve_batch_matches_single_device():
    pb = _batch(2, len(MESH) * 2)
    ref = solve_batch(pb, W, CFG)
    got = solve_batch(pb, W, CFG, mesh=MESH)
    _assert_batches_equivalent(pb, got, ref)
    assert got.alloc.X.device == pb.device
    assert bool(feasible(pb, got.alloc).all())


def test_sharded_solve_batch_pads_non_divisible():
    b = len(MESH) + 1                        # forces the pad/slice path
    pb = _batch(3, b)
    got = solve_batch(pb, W, CFG, mesh=MESH)
    assert got.alloc.rho.shape == (b,) and got.trace.shape == (b, CFG.outer_iters)
    _assert_batches_equivalent(pb, got, solve_batch(pb, W, CFG))


def test_sharded_weights_batched():
    p = tree_index(_batch(4, 1), 0)
    ws = [Weights(torch.tensor(1.0 + i), torch.tensor(1.0), torch.tensor(1.0))
          for i in range(len(MESH))]
    pb, wb = stack_params([p] * len(MESH)), stack_weights(ws)
    ref = solve_batch(pb, wb, CFG, weights_batched=True)
    got = solve_batch(pb, wb, CFG, weights_batched=True, mesh=MESH)
    _assert_batches_equivalent(pb, got, ref, weights=wb)


def test_sharded_warm_starts_shard_with_their_scenarios():
    """`extra_starts` split with their scenarios: a mixed hit/miss batch
    the mesh does not divide gives the unsharded refine's X."""
    pb = _batch(5, 3)
    cold = solve_batch(pb, W, CFG)
    a = cold.alloc
    extra = ExtraStart(a.f.numpy(), a.P.numpy(), a.X.numpy(), np.array([1.0, 0.0, 1.0], np.float32))
    ref = solve_batch(pb, W, CFG, extra_starts=extra)
    got = solve_batch(pb, W, CFG, extra_starts=extra, mesh=MESH[:2])
    _assert_batches_equivalent(pb, got, ref)


# ---------------------------------------------------------------------------
# sharded serving
# ---------------------------------------------------------------------------

SHARD_SERVE = ServeConfig(
    policy=BatchPolicy(max_batch=2, max_wait_s=0.01),
    allocator=AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=40)),
    shard_batch=True,
)


def test_sharded_service_slots_and_cache():
    """shard_batch sizes bucket slots to len(mesh) x max_batch, and the
    solver cache keys on the mesh (a shared dict never hands an unsharded
    solver to a sharded service, or the other way round)."""
    sharded = AllocService(SHARD_SERVE, device="cpu", mesh=MESH)
    assert sharded.mesh == MESH
    assert sharded._full_slots == 2 * len(MESH)
    assert sharded.batcher.policy.max_batch == 2 * len(MESH)
    p = FAMILY.sample(5, N=4, K=8, device="cpu")
    sharded.warmup([p])
    assert sharded.metrics.cache_misses == 1
    single = AllocService(SHARD_SERVE._replace(shard_batch=False),
                          executables=sharded.executables, device="cpu")
    assert single.mesh is None and single._full_slots == 2
    single.warmup([p])
    assert single.metrics.cache_misses == 1     # same bucket and config, no mesh: a miss
    assert len(sharded.executables) == 2
    assert {k[3] for k in sharded.executables} == {MESH, None}


def test_sharded_service_matches_unsharded():
    """The same requests answered by a sharded and an unsharded service get
    identical hardened assignments (the batch axis split is invisible)."""
    requests = [FAMILY.sample(10 + i, N=4, K=8, device="cpu") for i in range(3)]
    results = {}
    for name, shard in (("sharded", True), ("single", False)):
        service = AllocService(SHARD_SERVE._replace(shard_batch=shard), device="cpu", mesh=MESH)
        for p in requests:
            service.submit(p, now=0.0)
        done, _ = service.drain(now=0.0)
        results[name] = {c.req_id: c.alloc for c in done}
    assert sorted(results["sharded"]) == sorted(results["single"]) == [0, 1, 2]
    for rid, p in enumerate(requests):
        a, b = results["sharded"][rid], results["single"][rid]
        assert torch.equal(a.X, b.X)
        np.testing.assert_allclose(float(objective(p, W, a)), float(objective(p, W, b)), rtol=1e-2)
        assert bool(feasible(p, a))
