"""The port's baselines (`repro_torch.core.baselines`, paper §V-B) against
the JAX reference's, on the CPU, on the same numpy-drawn scenarios.

* `equal_allocation` and `comp_opt_only` are deterministic: leaf for leaf
  at rtol 1e-6.
* `comm_opt_only` draws f at random (from a JAX key there, a torch seed
  here); its P and X do not depend on f. X is held at the PGD stage
  tolerance of `tests/test_torch_allocator.py` (rtol 1e-4), and P, after
  800 Adam steps, at the reference's own spread: the planned 1e-3 p_max
  plus three times the range of the reference's answers over one-ulp
  copies of the channel gains (ROADMAP.md §3; the reference's own range
  reaches 4e-3 p_max on seed 2).
* `random_allocation` draws its owners and powers: one owner per
  subcarrier, powers within p_max, and the reference's constant
  f = 0.1 f_max (ROADMAP.md §3).
* A batch solves as its scenarios one by one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import Weights as JWeights
from repro.core import baselines as JB
from repro_torch.core import Weights, tree_index
from repro_torch.core import baselines as B
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.system import feasible
from torch_parity_spread import ulp_inputs
from torch_port_util import both_params, np_, numpy_scenarios, port_weights

torch.set_num_threads(1)
LEAVES = ("f", "P", "X", "rho")
#: the allocator tests' factor on the reference's one-ulp spread
SPREAD_FACTOR = 3.0

_jcomm = jax.jit(lambda p: JB.comm_opt_only(p, JWeights.ones(), jax.random.PRNGKey(0)))


def _scenario(seed, **kw):
    return both_params(*numpy_scenarios(seed, N=4, K=12, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", ["equal", "comp_only"])
def test_deterministic_baselines_match_reference(which, seed):
    p, tp = _scenario(seed)
    if which == "equal":
        want, got = JB.equal_allocation(p), B.equal_allocation(tp)
    else:
        want, got = JB.comp_opt_only(p, JWeights.ones()), B.comp_opt_only(tp, port_weights())
    for leaf in LEAVES:
        w, g = np.asarray(getattr(want, leaf)), np_(getattr(got, leaf))
        assert g.shape == w.shape and g.dtype == np.float32, leaf
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=leaf)


@pytest.mark.parametrize("seed", [0, 2])
def test_comm_opt_only_matches_reference(seed):
    arrays, meta = numpy_scenarios(seed, N=4, K=12)
    ref_P, port_P = [], []
    for i, a in enumerate(ulp_inputs(arrays, 6, 100 + seed)):
        p, tp = both_params(a, meta)
        want = _jcomm(p)
        ref_P.append(np.asarray(want.P))
        if i >= 3:
            continue
        got = B.comm_opt_only(tp, port_weights(), seed)
        port_P.append(np_(got.P))
        if i == 0:
            np.testing.assert_allclose(np_(got.X), np.asarray(want.X), rtol=1e-4, atol=1e-9)
            np.testing.assert_array_equal(np_(got.X) > 0.5, np.asarray(want.X) > 0.5)
            f = np_(got.f)
            assert np.all((f >= 0.5e9) & (f <= 1.5e9)) and float(got.rho) == 1.0
    R, Q = np.stack(ref_P), np.stack(port_P)
    lo, hi = R.min(0), R.max(0)
    gap = np.maximum(np.maximum(Q.min(0) - hi, lo - Q.max(0)), 0.0)
    limit = 1e-3 * arrays["p_max"][:, None] + SPREAD_FACTOR * (hi - lo)
    assert np.all(gap <= limit), f"P outside the reference's spread by {np.max(gap - limit)}"


def test_comm_opt_only_p_and_x_do_not_depend_on_f():
    _, tp = _scenario(4)
    a = B.comm_opt_only(tp, port_weights(), 0, PGDConfig(steps=40))
    b = B.comm_opt_only(tp, port_weights(), torch.Generator().manual_seed(9), PGDConfig(steps=40))
    assert not torch.equal(a.f, b.f)
    assert torch.equal(a.P, b.P) and torch.equal(a.X, b.X)


@pytest.mark.parametrize("seed", [0, 5])
def test_random_allocation_law(seed):
    _, tp = _scenario(seed, batch=8)
    a = B.random_allocation(tp, seed)
    X, P = np_(a.X), np_(a.P)
    assert set(np.unique(X)) <= {0.0, 1.0} and np.all(X.sum(-2) == 1)
    assert np.all(P >= 0) and np.all(P[X == 0] == 0)
    assert np.all(P.sum(-1) <= np_(tp.p_max) * (1 + 1e-6))
    # the reference's f: jax.random.uniform(minval=0.1e9) with maxval 1.0
    # clamps every draw to 1e8, so f = 0.1 f_max (ROADMAP.md §3)
    p0, _ = _scenario(seed)
    want_f = np.asarray(JB.random_allocation(p0, jax.random.PRNGKey(seed)).f)
    np.testing.assert_array_equal(want_f, np.float32(0.1) * np.float32(2e9) * np.ones(4, np.float32))
    np.testing.assert_array_equal(np_(a.f), np.broadcast_to(want_f, X.shape[:-1]))
    assert np.all(np_(a.rho) == 1.0)
    assert bool(feasible(tp, a).any())


def test_batched_call_equals_per_scenario_calls():
    """Leading batch axes: each row equals the call on that scenario alone
    (for the random baselines, the leaves that do not depend on the draw)."""
    _, tp = _scenario(7, batch=3)
    w = Weights.ones()
    calls = [("equal", B.equal_allocation, LEAVES), ("comp_only", lambda p: B.comp_opt_only(p, w), LEAVES),
             ("comm_only", lambda p: B.comm_opt_only(p, w, 0, PGDConfig(steps=40)), ("P", "X", "rho")),
             ("random", lambda p: B.random_allocation(p, 0), ("f", "rho"))]
    for name, fn, leaves in calls:
        batched = fn(tp)
        for b in range(3):
            one = fn(tree_index(tp, b))
            for leaf in leaves:
                np.testing.assert_allclose(np_(getattr(batched, leaf))[b], np_(getattr(one, leaf)),
                                           rtol=1e-6, atol=0, err_msg=f"{name}.{leaf}[{b}]")
    # per-scenario weights: row b takes kappa1[b]
    wb = Weights(torch.tensor([0.5, 1.0, 2.0]), torch.ones(3), torch.ones(3))
    batched = B.comp_opt_only(tp, wb)
    for b in range(3):
        one = B.comp_opt_only(tree_index(tp, b), Weights(*(torch.as_tensor(x[b]) for x in
                                                             (wb.kappa1, wb.kappa2, wb.kappa3))))
        np.testing.assert_allclose(np_(batched.f[b]), np_(one.f), rtol=1e-6)
