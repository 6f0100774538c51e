"""Parity of the port's system model, scoring, types, scenarios and bridge
with the JAX reference, on the CPU.

Scenarios are drawn by the reference and handed to the port as numpy
arrays (`repro_torch.bridge`). Objectives agree to rtol 1e-5 (float32
round-off of the reductions); masks, paddings and feasibility exactly.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    Allocation as JAllocation, Weights as JWeights, pad_params as jpad,
    sample_params, stack_params as jstack,
)
from repro.core.allocator import equal_start as jequal, harden_x as jharden
from repro.core.system import feasible as jfeasible, objective as jobjective
from repro.core.system import report as jreport
from repro_torch import bridge
from repro_torch.core import (
    Allocation, ShapeBucket, SystemParams, Weights, batch_objectives, bucket_for,
    candidate_objectives, pad_params, stack_params, stack_weights, tree_index,
    unpad_alloc,
)
from repro_torch.core.allocator import equal_start, harden_x, low_power_start
from repro_torch.core.scoring import scenario_objective
from repro_torch.core.system import feasible, objective, report
from repro_torch.scenarios import get_family
from torch_port_util import np_, port_weights, to_port_alloc, to_port_params

torch.set_num_threads(1)


def _padded_bucket_batch():
    """The padded-bucket batch of tests/test_kernels.py:279: four scenarios
    of mixed size padded into (4, 8), garbage f on padded rows, per-scenario
    weights."""
    scenarios, allocs, weights = [], [], []
    bbar = 20e6 / 8
    for i, (n, k) in enumerate([(3, 7), (4, 8), (2, 5), (4, 8)]):
        p = sample_params(jax.random.PRNGKey(20 + i), N=n, K=k, B=bbar * k)
        pp = jpad(p, 4, 8)
        f, P, X = jequal(pp)
        X = jharden(X, pp.N, pp.K, pp.dev_mask, pp.sc_mask)
        f = jnp.where(pp.dev_mask > 0, f, 2.0)
        scenarios.append(pp)
        allocs.append(JAllocation(f=f, P=P, X=X, rho=jnp.float32(0.4 + 0.1 * i)))
        weights.append((0.5 + i, 1.0, 1.5))
    return scenarios, allocs, weights


def _port_batch(scenarios, allocs, weights):
    pb = stack_params([to_port_params(p) for p in scenarios])
    ab = Allocation(*(
        torch.stack([getattr(to_port_alloc(a), k) for a in allocs])
        for k in ("f", "P", "X", "rho")
    ))
    wb = stack_weights([port_weights(*w) for w in weights])
    return pb, ab, wb


def _reference_per_scenario(fn, scenarios, allocs, weights=None):
    """``fn`` of the reference on each scenario, as one jitted vmap."""
    pb = jstack(scenarios)
    ab = jax.tree.map(lambda *xs: jnp.stack(xs), *allocs)
    if weights is None:
        return jax.jit(jax.vmap(fn))(pb, ab)
    wb = JWeights(*(jnp.asarray([w[i] for w in weights], jnp.float32) for i in range(3)))
    return jax.jit(jax.vmap(fn))(pb, wb, ab)


def test_objective_feasible_report_match_reference_on_padded_batch():
    scenarios, allocs, weights = _padded_bucket_batch()
    pb, ab, wb = _port_batch(scenarios, allocs, weights)
    np.testing.assert_allclose(
        np_(objective(pb, wb, ab)),
        np.asarray(_reference_per_scenario(jobjective, scenarios, allocs, weights)),
        rtol=1e-5,
    )
    np.testing.assert_array_equal(
        np_(feasible(pb, ab)),
        np.asarray(_reference_per_scenario(jfeasible, scenarios, allocs)),
    )
    got = report(pb, wb, ab)
    want = _reference_per_scenario(jreport, scenarios, allocs, weights)
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_allclose(np_(got[key]), np.asarray(val), rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("use_kernel", ["auto", False])
def test_batch_scoring_matches_reference_objective(use_kernel):
    """`scoring.batch_objectives` (the kernel path, plain version on the CPU)
    == the reference's mask-aware `system.objective`, scenario by scenario."""
    scenarios, allocs, weights = _padded_bucket_batch()
    pb, ab, wb = _port_batch(scenarios, allocs, weights)
    got = batch_objectives(pb, wb, ab, weights_batched=True, use_kernel=use_kernel)
    want = _reference_per_scenario(jobjective, scenarios, allocs, weights)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5)


def test_candidate_scoring_matches_reference_objective():
    """Multi-start scoring (G candidates of one scenario, and of a batch)."""
    from repro.core.allocator import low_power_start as jlow

    p = sample_params(jax.random.PRNGKey(30), N=4, K=12)
    cands = []
    for start, rho in [(jequal(p), 0.9), (jlow(p), 0.5)]:
        f, P, X = start
        cands.append(JAllocation(f=f, P=P, X=X, rho=jnp.float32(rho)))
    want = np.asarray([float(jobjective(p, JWeights.ones(), a)) for a in cands])
    tp = to_port_params(p)
    stacked = Allocation(*(
        torch.stack([getattr(to_port_alloc(a), k) for a in cands])
        for k in ("f", "P", "X", "rho")
    ))
    got = candidate_objectives(tp, port_weights(), stacked)
    np.testing.assert_allclose(np_(got), want, rtol=1e-5)
    # the same two candidates for a batch of two identical scenarios
    tb = stack_params([tp, tp])
    sb = Allocation(*(torch.stack([x, x]) for x in (stacked.f, stacked.P, stacked.X, stacked.rho)))
    got_b = candidate_objectives(tb, port_weights(), sb)
    torch.testing.assert_close(got_b, torch.stack([got, got]), rtol=0, atol=0)


def test_padded_scenario_scores_like_exact():
    """Inside the port: a `pad_params`-padded scenario scores like the
    exact-shape one, through `system.objective` and the kernel path."""
    p = to_port_params(sample_params(jax.random.PRNGKey(9), N=3, K=7))
    pp = pad_params(p, ShapeBucket(4, 8))
    w = port_weights(0.7, 1.0, 1.2)
    f, P, X = equal_start(p)
    X = harden_x(X, p.N, p.K)
    alloc = Allocation(f=f, P=P, X=X, rho=torch.tensor(0.6))
    fp, Pp, Xp = equal_start(pp)
    Xp = harden_x(Xp, pp.N, pp.K, pp.dev_mask, pp.sc_mask)
    np.testing.assert_array_equal(np_(Xp[:3, :7]), np_(X))
    fp = torch.where(pp.dev_mask > 0, fp, 2.0)        # garbage on the padded row
    palloc = Allocation(f=fp, P=Pp, X=Xp, rho=torch.tensor(0.6))
    want = float(objective(p, w, alloc))
    np.testing.assert_allclose(float(objective(pp, w, palloc)), want, rtol=1e-6)
    np.testing.assert_allclose(float(scenario_objective(pp, w, palloc)), want, rtol=1e-6)
    back = unpad_alloc(palloc, 3, 7)
    np.testing.assert_array_equal(np_(back.X), np_(X))


def test_types_match_reference():
    """pad_params keeps bbar exactly and pads like the reference; starts and
    bucket_for agree; stack/tree_index round-trip."""
    p = sample_params(jax.random.PRNGKey(0), N=3, K=8)
    pp = jpad(p, 4, 12)
    tp = pad_params(to_port_params(p), 4, 12)
    for k in ("g", "c", "d", "D", "C", "p_max", "f_max", "t_sc_max", "dev_mask", "sc_mask"):
        np.testing.assert_array_equal(np_(getattr(tp, k)), np.asarray(getattr(pp, k)), err_msg=k)
    assert (tp.N, tp.K, tp.B) == (pp.N, pp.K, pp.B) and tp.bbar == pp.bbar
    assert pad_params(tp, 4, 12) is tp
    with pytest.raises(ValueError, match="shrink"):
        pad_params(tp, 3, 12)
    assert bucket_for(3, 8) == ShapeBucket(4, 8) and bucket_for(10, 50) == ShapeBucket(16, 64)
    for jstart, tstart in ((jequal, equal_start),):
        for a, b in zip(jstart(pp), tstart(tp)):
            np.testing.assert_array_equal(np_(b), np.asarray(a))
    from repro.core.allocator import low_power_start as jlow
    for a, b in zip(jlow(pp), low_power_start(tp)):
        np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-6, atol=0)
    batch = stack_params([tp, tp])
    assert batch.g.shape == (2, 4, 12) and batch.N == 4
    np.testing.assert_array_equal(np_(tree_index(batch, 1).g), np_(tp.g))
    with pytest.raises(ValueError, match="K >= N"):
        SystemParams(*(getattr(tp, k) for k in ("g", "c", "d", "D", "C", "p_max", "f_max", "t_sc_max")), N=5, K=4)
    jb = jstack([pp, pp])
    np.testing.assert_array_equal(np_(batch.dev_mask), np.asarray(jb.dev_mask))


def test_iid_rayleigh_draws_the_table1_law():
    """Same distribution as the reference family, drawn with a torch
    Generator: Table-I population, c in [1e4, 3e4], positive gains whose
    small-scale fading has unit mean, reproducible from the seed."""
    fam = get_family("iid_rayleigh")
    pb = fam.sample_batch(0, 64, N=10, K=50, device="cpu")
    assert pb.g.shape == (64, 10, 50) and pb.g.dtype == torch.float32
    assert (pb.N, pb.K, pb.B) == (10, 50, 20e6)
    ref = sample_params(jax.random.PRNGKey(0), N=10, K=50)
    for k in ("d", "D", "C", "p_max", "f_max", "t_sc_max", "dev_mask", "sc_mask"):
        np.testing.assert_array_equal(np_(getattr(pb, k)[3]), np.asarray(getattr(ref, k)), err_msg=k)
    assert float(pb.c.min()) >= 1e4 and float(pb.c.max()) <= 3e4
    assert bool((pb.g > 0).all())
    # per-device large-scale gain factors out; the fading has mean 1
    fading = pb.g / pb.g.mean(dim=-1, keepdim=True)
    assert abs(float(fading.mean()) - 1.0) < 1e-5
    assert 0.9 < float(fading.var()) < 1.1         # exponential(1): variance 1
    again = fam.sample_batch(0, 64, N=10, K=50, device="cpu")
    torch.testing.assert_close(again.g, pb.g, rtol=0, atol=0)
    one = fam.sample(torch.Generator().manual_seed(1), N=4, K=12, device="cpu")
    assert one.g.shape == (4, 12) and one.dev_mask.shape == (4,)


def test_entry_points_default_to_cuda():
    """Without a card, `scenarios` and `bridge` refuse the default device
    rather than running on the CPU; with one, they draw on it."""
    fam = get_family("iid_rayleigh")
    if torch.cuda.is_available():
        assert fam.sample(0, N=4, K=8).g.is_cuda
        assert bridge.weights_from_numpy({"kappa1": 1, "kappa2": 1, "kappa3": 1}).kappa1.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fam.sample(0, N=4, K=8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bridge.weights_from_numpy({"kappa1": 1, "kappa2": 1, "kappa3": 1})


def test_bridge_round_trip():
    p = sample_params(jax.random.PRNGKey(5), N=4, K=12)
    tp = to_port_params(p)
    assert tp.device.type == "cpu" and tp.xi == p.xi and tp.q == p.q
    f, P, X = jequal(p)
    alloc = JAllocation(f=f, P=P, X=X, rho=jnp.float32(0.5))
    back = bridge.allocation_to_numpy(to_port_alloc(alloc))
    for k in ("f", "P", "X", "rho"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(alloc, k)))
    acc = bridge.accuracy_from_numpy({"a": [0.6, 0.5], "b": [0.4, 0.3]}, device="cpu")
    assert acc.a.shape == (2,)
    with pytest.raises(ValueError, match="unknown"):
        bridge.params_from_numpy({"gain": np.ones((2, 2))}, {}, device="cpu")
    assert Weights.ones().kappa1.shape == ()


def test_package_imports_neither_jax_nor_reference():
    """The port stands alone: importing it loads no JAX and nothing of the
    reference package."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.scenarios, repro_torch.bridge\n"
        "import repro_torch.kernels.fedsem_objective.ops\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**__import__("os").environ, "PYTHONPATH": str(
            __import__("pathlib").Path(__file__).resolve().parents[1] / "src"
        )},
    )
    assert out.returncode == 0, out.stderr
