"""The port's exhaustive oracle (`repro_torch.core.exhaustive`, paper Table
II) against the JAX reference's, on the CPU, on the reference's own draws.

On the CPU the port scores through the objective kernel's plain version;
the reference through its jnp oracle, as its own tests do. For each
family's draw at ``PRNGKey(2)``, N 3, K 4 (the reference's oracle gate,
`tests/test_scenarios.py:169`), exact-shape and `pad_params`-padded, both
sweep the same grid and must return the same X, the same f, P and rho (to
float32 rounding), the same value (rtol 1e-5) and the same count.

The oracle gate (the oracle not more than 35% better than Alg. A2) holds
the port for ``iid_rayleigh``, ``ris_geometry`` and ``hetero_classes``. On
``gauss_markov`` the reference itself fails that gate (ROADMAP.md §3: the
multi-start does not reach the oracle's assignment), so there the port's
Alg. A2 is held to the reference's Alg. A2 instead: the same X, and f,
rho, P and the objective within the reference's own spread over one-ulp
copies of the channel gains, as `tests/test_torch_allocator.py` holds
whole solves.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import AllocatorConfig as JConfig, Allocation as JAllocation, Weights as JWeights
from repro.core import pad_params as jpad, solve_batch as jsolve_batch, stack_params as jstack
from repro.core.exhaustive import solve_exhaustive as jsolve_exhaustive
from repro.core.system import objective as jobjective
from repro.core.types import dbm_to_watt as jdbm_to_watt
from repro.scenarios import get_family as jget_family
from repro_torch import bridge
from repro_torch.core import AllocatorConfig, Weights, solve_batch, stack_params, tree_index
from repro_torch.core.exhaustive import power_levels_watt, solve_exhaustive
from repro_torch.core.system import feasible, report
from torch_parity_spread import ulp_inputs
from torch_port_util import jax_params_to_numpy, np_, port_weights, to_port_params

torch.set_num_threads(1)
FAMILIES = ("gauss_markov", "hetero_classes", "iid_rayleigh", "ris_geometry")
#: the reference's oracle-gate config (tests/test_scenarios.py:FULL_PGD)
FULL_PGD = AllocatorConfig(inner="pgd")
GATE = 0.35
#: the allocator tests' factor on the reference's one-ulp spread, and the
#: planned tolerances (objective rtol 1e-4; f and rho rtol 1e-3; P atol
#: 1e-3 p_max)
SPREAD_FACTOR = 3.0


@functools.lru_cache(maxsize=None)
def _draw(name):
    """The reference's oracle-gate draw of a family, as numpy."""
    return jax_params_to_numpy(jget_family(name).sample(jax.random.PRNGKey(2), N=3, K=4))


def _jparams(arrays, meta):
    from repro.core import SystemParams

    return SystemParams(**{k: jax.numpy.asarray(v) for k, v in arrays.items()}, **meta)


def _grids(arrays, small=False):
    """The oracle gate's grids, within the tightest device's f_max and p_max
    (`tests/test_scenarios.py:177-184`); ``small`` cuts each by a level."""
    f_hi = float(np.min(arrays["f_max"]))
    p_hi_dbm = 10.0 * np.log10(float(np.min(arrays["p_max"]))) + 30.0
    n = 1 if small else 0
    return (np.linspace(0.25e9, f_hi, 4 - n), np.linspace(4.0, p_hi_dbm, 3 - n),
            np.linspace(0.2, 1.0, 4 - n))


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
@pytest.mark.parametrize("name", FAMILIES)
def test_exhaustive_matches_reference(name, padded):
    arrays, meta = _draw(name)
    jp = _jparams(arrays, meta)
    grids = _grids(arrays, small=padded)
    if padded:
        jp = jpad(jp, 4, 5)
    want = jsolve_exhaustive(jp, JWeights.ones(), *grids)
    got = solve_exhaustive(to_port_params(jp), port_weights(), *grids)
    np.testing.assert_array_equal(np_(got.alloc.X), np.asarray(want.alloc.X))
    for leaf in ("f", "P", "rho"):
        w, g = np.asarray(getattr(want.alloc, leaf)), np_(getattr(got.alloc, leaf))
        assert g.dtype == np.float32 and g.shape == w.shape, leaf
        np.testing.assert_array_equal(g, w, err_msg=leaf)
    np.testing.assert_allclose(float(got.value), float(want.value), rtol=1e-5)
    assert got.n_evaluated == want.n_evaluated
    if padded:
        assert got.n_evaluated == 4**5 * 3**4 * 2**4 * 3


def test_power_levels_round_as_the_reference():
    dbm = np.concatenate([np.linspace(4, 20, n) for n in (2, 3, 4, 5)]
                         + [[10.0 * np.log10(float(np.float32(x))) + 30.0 for x in (0.1, 0.0501187, 0.1995262)]])
    np.testing.assert_array_equal(power_levels_watt(dbm), np.asarray(jdbm_to_watt(jax.numpy.asarray(dbm))))


def test_exhaustive_value_is_the_objective_of_its_allocation():
    arrays, meta = _draw("iid_rayleigh")
    tp = bridge.params_from_numpy(arrays, meta, device="cpu")
    ex = solve_exhaustive(tp, port_weights(), *_grids(arrays))
    assert bool(feasible(tp, ex.alloc))
    obj = float(report(tp, port_weights(), ex.alloc)["objective"])
    np.testing.assert_allclose(float(ex.value), obj, rtol=1e-5)


def test_exhaustive_raises_when_every_candidate_is_infeasible():
    arrays, meta = _draw("iid_rayleigh")
    tight = dict(arrays, t_sc_max=np.full_like(arrays["t_sc_max"], 1e-6))
    tp = bridge.params_from_numpy(tight, meta, device="cpu")
    with pytest.raises(ValueError, match="every candidate in the grid is infeasible"):
        solve_exhaustive(tp, port_weights(), *_grids(arrays, small=True))
    with pytest.raises(ValueError, match="one scenario"):
        solve_exhaustive(stack_params([tp, tp]), port_weights(), *_grids(arrays, small=True))


@pytest.fixture(scope="module")
def port_solves():
    """The port's Alg. A2 (FULL_PGD) in one batch: each family's draw, then
    the first two one-ulp copies of ``gauss_markov``'s (all gains up, all
    down)."""
    arrays, meta = _draw("gauss_markov")
    inputs = [_draw(n) for n in FAMILIES] + [(a, meta) for a in ulp_inputs(arrays, 3, 102)[1:]]
    tp = stack_params([bridge.params_from_numpy(a, m, device="cpu") for a, m in inputs])
    return inputs, tp, solve_batch(tp, Weights.ones(), FULL_PGD)


@pytest.mark.parametrize("name", ["hetero_classes", "iid_rayleigh", "ris_geometry"])
def test_exhaustive_oracle_gate(name, port_solves):
    """Table-II gate per family: the oracle not much better than Alg. A2."""
    inputs, tp, res = port_solves
    i = FAMILIES.index(name)
    p = tree_index(tp, i)
    obj = float(report(p, Weights.ones(), tree_index(res.alloc, i))["objective"])
    ex = solve_exhaustive(p, Weights.ones(), *_grids(inputs[i][0]))
    assert np.isfinite(float(ex.value))
    assert float(ex.value) >= obj - GATE * abs(obj), (
        f"{name}: oracle {float(ex.value)} much better than proposed {obj}")


def test_gauss_markov_allocator_matches_reference(port_solves):
    """Where the reference fails its own oracle gate, the port's Alg. A2
    gives the reference's answer: the same X, and the leaves within the
    reference's spread over six one-ulp copies of the gains (for the
    objective, one-sided: the port may be better)."""
    inputs, tp, res = port_solves
    arrays, meta = _draw("gauss_markov")
    members = ulp_inputs(arrays, 6, 102)
    jb = jstack([_jparams(a, meta) for a in members])
    want = jax.jit(lambda p: jsolve_batch(p, JWeights.ones(), JConfig(inner="pgd")))(jb)
    jobj = jax.vmap(lambda p, a: jobjective(p, JWeights.ones(), a))
    rows = [FAMILIES.index("gauss_markov"), len(FAMILIES), len(FAMILIES) + 1]
    port = JAllocation(*(jax.numpy.asarray(np_(getattr(res.alloc, k))[rows]) for k in ("f", "P", "X", "rho")))
    np.testing.assert_array_equal(np.asarray(port.X[0]), np.asarray(want.alloc.X[0]))
    ref = dict(obj=np.asarray(jobj(jb, want.alloc)), f=np.asarray(want.alloc.f),
               rho=np.asarray(want.alloc.rho), P=np.asarray(want.alloc.P))
    got = dict(obj=np.asarray(jobj(jstack([_jparams(a, meta) for a in members[:3]]), port)),
               f=np.asarray(port.f), rho=np.asarray(port.rho), P=np.asarray(port.P))
    for leaf, R in ref.items():
        Q = got[leaf]
        lo, hi = R.min(0), R.max(0)
        if leaf == "P":
            planned = 1e-3 * arrays["p_max"][:, None]
        else:
            planned = (1e-4 if leaf == "obj" else 1e-3) * np.abs(R[0])
        above = np.maximum(Q.min(0) - hi, 0.0)
        gap = above if leaf == "obj" else np.maximum(above, np.maximum(lo - Q.max(0), 0.0))
        limit = planned + SPREAD_FACTOR * (hi - lo)
        assert np.all(gap <= limit), f"{leaf}: port {Q} vs reference [{lo}, {hi}] beyond {limit}"
