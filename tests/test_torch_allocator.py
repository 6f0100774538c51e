"""Parity of the port's Alg. A2 solver (`repro_torch.core`: p3, pgd, p5,
allocator) with the JAX reference, on the CPU, plus the equivalence rows
the port proves about itself.

Scenarios are drawn with numpy (the Table-I law) and handed to both. The
configs are the reference's tiny serving configs
(tests/test_serve_alloc.py: PGD_CFG, SCA_CFG).

What is held to the reference, and how tightly:

* the hardened assignment X of `solve_batch`: identical, on every case;
* the closed forms and short runs (Theorem 1, `harden_x`, 20 PGD steps,
  the finishing stage from the equal start): to float32 round-off;
* the continuous leaves of a whole solve (f, P, rho, the objective):
  against the reference's own spread, not a fixed tolerance. They depend
  on rounding noise in the reference itself. Adam turns gradients that are
  analytically zero (the sigma gradient of the primal-dual loop is zero at
  its nu initialisation) into steps of learning-rate size, so moving every
  channel gain by one ulp moves the reference's own f by up to a few
  percent. The port's answers over one-ulp copies of the input must
  overlap the reference's, up to a few times that spread. The measured
  deviations are in ROADMAP.md §3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    Allocation as JAllocation, AllocatorConfig as JConfig, Weights as JWeights,
    pad_params as jpad,
)
from repro.core.allocator import (
    equal_start as jequal, harden_x as jharden, low_power_start as jlow,
    repair_rate_floor as jrepair,
)
from repro.core.p3 import solve_p3 as jp3
from repro.core.p5 import P5Config as JP5, r_min as jr_min, solve_p5 as jp5
from repro.core.p5 import _linear_cap as jlinear_cap, penalty_J as jpenalty
from repro.core.pgd import PGDConfig as JPGD, power_given_x as jpower, solve_p4_pgd as jpgd
from repro.core.system import objective as jobjective
from repro_torch.core import (
    AllocatorConfig, Allocation, Weights, default_accuracy, pad_params, solve,
    solve_batch, stack_accuracy, stack_params, stack_weights, tree_index,
    unpad_alloc,
)
from repro_torch.core.allocator import (
    equal_start, harden_x, low_power_start, repair_rate_floor,
)
from repro_torch.core.p3 import solve_p3
from repro_torch.core.p5 import P5Config, _linear_cap, penalty_J, r_min, solve_p5
from repro_torch.core.pgd import PGDConfig, power_given_x, solve_p4_pgd
from repro_torch.core.system import feasible, objective
from torch_parity_spread import leaf_spread, reference_jitted
from torch_port_util import both_params, np_, numpy_scenarios, port_weights

torch.set_num_threads(1)

CONFIGS = {
    "pgd": (
        JConfig(inner="pgd", outer_iters=2, pgd=JPGD(steps=80)),
        AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=80)),
    ),
    "sca": (
        JConfig(inner="sca", outer_iters=2, p5=JP5(outer_iters=2, inner_iters=40)),
        AllocatorConfig(inner="sca", outer_iters=2, p5=P5Config(outer_iters=2, inner_iters=40)),
    ),
}
STARTS = {"equal": (jequal, equal_start), "low_power": (jlow, low_power_start)}


def _scenario(seed, N=4, K=12, batch=None):
    return both_params(*numpy_scenarios(seed, N=N, K=K, batch=batch))


# the reference's functions, jitted once with the scenario as an argument
_jp3 = jax.jit(lambda p, P, X: jp3(p, JWeights.ones(), P, X))
_jharden = jax.jit(jharden, static_argnums=(1, 2))
_jsolve_batch, _ = reference_jitted()        # shared with `leaf_spread`
_jpgd20 = jax.jit(
    lambda p, payload, rmin, P, X: jpgd(p, 1.0, payload, rmin, P, X, JPGD(steps=20))
)
_jp5 = jax.jit(
    lambda p, s, P, X: jp5(p, JWeights.ones(), s.rho, s.T, s.f, P, X,
                           JP5(outer_iters=2, inner_iters=10))
)


@jax.jit
def _jfinish(p, P, X):
    """The reference's finishing stage of `_solve_from` from (P, X)."""
    Xb = jharden(X, p.N, p.K, p.dev_mask, p.sc_mask)
    s = jp3(p, JWeights.ones(), P * Xb, Xb)
    rmin = jr_min(p, s.rho, s.T, s.f)
    P = jpower(p, 1.0, p.D + s.rho * p.C, rmin, Xb, P0=P * Xb)
    P = jrepair(p, P, Xb, rmin)
    s = jp3(p, JWeights.ones(), P, Xb)
    return s.f, P, Xb, s.rho, jobjective(p, JWeights.ones(), JAllocation(s.f, P, Xb, s.rho))


def _rel(got, want):
    got, want = np_(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", sorted(STARTS))
@pytest.mark.parametrize("seed", [0, 3])
def test_solve_p3_matches_reference(start, seed):
    """Theorem 1 (fixed-count bisections) to rtol 1e-5."""
    p, tp = _scenario(seed)
    jstart, tstart = STARTS[start]
    _, P, X = jstart(p)
    _, tP, tX = tstart(tp)
    want = _jp3(p, P, X)
    got = solve_p3(tp, port_weights(), tP, tX)
    for leaf in ("f", "rho", "T"):
        np.testing.assert_allclose(np_(getattr(got, leaf)), np.asarray(getattr(want, leaf)),
                                   rtol=1e-5, err_msg=leaf)


def test_harden_x_matches_reference_with_masks_and_ties():
    """`harden_x` exactly: ties go to the first index, padded devices never
    win, padded subcarriers stay unassigned, devices left empty steal from
    the richest owners."""
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(6, 10)).astype(np.float32)
    X[:, 2] = 0.5                                  # an all-way tie
    X[1, 4] = X[3, 4] = 0.99                       # a two-way tie
    X[5] = 0.0                                     # a device that wins nothing
    dev_mask = np.asarray([1, 1, 1, 1, 1, 0], np.float32)
    sc_mask = np.asarray([1] * 8 + [0] * 2, np.float32)
    Xb = np.stack([X, X[::-1].copy(), np.zeros_like(X)])   # batch, incl. an all-zero X
    for masks in ((None, None), (dev_mask, sc_mask)):
        for x in Xb:
            want = _jharden(jnp.asarray(x), 6, 10, *(None if m is None else jnp.asarray(m) for m in masks))
            got = harden_x(torch.from_numpy(x), 6, 10, *(None if m is None else torch.from_numpy(m) for m in masks))
            np.testing.assert_array_equal(np_(got), np.asarray(want))
        batched = harden_x(torch.from_numpy(Xb), 6, 10, *(
            None if m is None else torch.from_numpy(np.stack([m] * 3)) for m in masks))
        for b, x in enumerate(Xb):
            np.testing.assert_array_equal(
                np_(batched[b]),
                np.asarray(_jharden(jnp.asarray(x), 6, 10, *(None if m is None else jnp.asarray(m) for m in masks))),
            )


def _p3_floor(p, tp, start):
    jstart, tstart = STARTS[start]
    _, P, X = jstart(p)
    _, tP, tX = tstart(tp)
    s = _jp3(p, P, X)
    payload = p.D + s.rho * p.C
    rmin = jr_min(p, s.rho, s.T, s.f)
    ts = solve_p3(tp, port_weights(), tP, tX)
    np.testing.assert_allclose(np_(r_min(tp, ts.rho, ts.T, ts.f)), np.asarray(rmin), rtol=1e-5)
    return (s, P, X, payload, rmin), (ts, tP, tX, torch.from_numpy(np.array(payload)),
                                      torch.from_numpy(np.array(rmin)))


@pytest.mark.parametrize("start", sorted(STARTS))
def test_solve_p4_pgd_matches_reference(start):
    """20 PGD steps (softmax decode, budgeted power, Adam on a float32 step
    counter) to rtol 1e-4."""
    p, tp = _scenario(1)
    (s, P, X, payload, rmin), (ts, tP, tX, tpay, trmin) = _p3_floor(p, tp, start)
    jP, jX = _jpgd20(p, payload, rmin, P, X)
    with torch.no_grad():
        gP, gX = solve_p4_pgd(tp, torch.tensor(1.0), tpay, trmin, tP, tX, PGDConfig(steps=20))
    np.testing.assert_allclose(np_(gP), np.asarray(jP), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(np_(gX), np.asarray(jX), rtol=1e-4, atol=1e-9)


def test_linear_cap_penalty_and_rate_floor_match_reference():
    """The P5 building blocks, values and gradients: the cap's clip splits
    its gradient 0.5/0.5 at a tie (X exactly 1.0 after a projection), as
    JAX's clip does."""
    p, tp = _scenario(2)
    rng = np.random.default_rng(0)
    x_bar = rng.uniform(size=(4, 12)).astype(np.float32)
    x_bar[0, :3] = 1.0
    x = x_bar.copy()
    x[1] = rng.uniform(size=12)
    jcap, jgrad = jax.value_and_grad(lambda x: jnp.sum(jlinear_cap(p, x, x_bar)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tcap = torch.sum(_linear_cap(tp, tx, torch.from_numpy(x_bar)))
    (tgrad,) = torch.autograd.grad(tcap, tx)
    np.testing.assert_allclose(float(tcap.detach()), float(jcap), rtol=1e-6)
    np.testing.assert_array_equal(np_(tgrad), np.asarray(jgrad))
    assert np.any(np_(tgrad)[0, :3] != np_(tgrad)[0, 3:].max())   # the tie rows differ
    np.testing.assert_allclose(
        float(penalty_J(torch.from_numpy(x), torch.from_numpy(x_bar))),
        float(jpenalty(jnp.asarray(x), jnp.asarray(x_bar))), rtol=1e-6)


def test_solve_p5_matches_reference_assignment():
    """SCA primal-dual (outer 2, inner 10): the relaxed X of the reference,
    and P inside its box with padded entries pinned to zero. P and sigma
    themselves follow the reference's rounding noise (module docstring)."""
    p, tp = _scenario(3)
    pp = jpad(p, 5, 14)
    tpp = pad_params(tp, 5, 14)
    for jp_, tp_ in ((p, tp), (pp, tpp)):
        _, P, X = jlow(jp_)
        _, tP, tX = low_power_start(tp_)
        ts = solve_p3(tp_, port_weights(), tP, tX)
        want = _jp5(jp_, _jp3(jp_, P, X), P, X)
        with torch.no_grad():
            got = solve_p5(tp_, port_weights(), ts.rho, ts.T, ts.f, tP, tX,
                           P5Config(outer_iters=2, inner_iters=10))
        np.testing.assert_allclose(np_(got.X), np.asarray(want.X), rtol=1e-4, atol=1e-6)
        assert got.h.shape == want.h.shape
        live = np_(tp_.dev_mask)[:, None] * np_(tp_.sc_mask)[None, :]
        assert np.all(np_(got.P) >= 0) and np.all(np_(got.P) <= np_(tp_.p_max)[:, None])
        assert np.all(np_(got.P)[live == 0] == 0) and np.all(np_(got.X)[live == 0] == 0)


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_finishing_stage_matches_reference(seed):
    """harden -> Theorem 1 -> `power_given_x` (600 Adam steps) -> rate-floor
    repair -> Theorem 1, from the equal start: objective to rtol 1e-4, f and
    rho to rtol 1e-3, P to atol 1e-3 * p_max."""
    p, tp = _scenario(seed)
    _, P, X = jequal(p)
    want = _jfinish(p, P, X)
    _, tP, tX = equal_start(tp)
    w = port_weights()
    with torch.no_grad():
        Xb = harden_x(tX, tp.N, tp.K, tp.dev_mask, tp.sc_mask)
        s = solve_p3(tp, w, tP * Xb, Xb)
        rmin = r_min(tp, s.rho, s.T, s.f)
        P2 = power_given_x(tp, w.kappa1, tp.D + s.rho * tp.C, rmin, Xb, P0=tP * Xb)
        P2 = repair_rate_floor(tp, P2, Xb, rmin)
        s = solve_p3(tp, w, P2, Xb)
        obj = objective(tp, w, Allocation(s.f, P2, Xb, s.rho))
    np.testing.assert_array_equal(np_(Xb), np.asarray(want[2]))
    np.testing.assert_allclose(np_(s.f), np.asarray(want[0]), rtol=1e-3)
    np.testing.assert_allclose(np_(s.rho), np.asarray(want[3]), rtol=1e-3)
    np.testing.assert_allclose(np_(P2), np.asarray(want[1]), rtol=0, atol=1e-3 * 0.1)
    np.testing.assert_allclose(float(obj), float(want[4]), rtol=1e-4)


# ---------------------------------------------------------------------------
# solve_batch against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_batch_hardened_x_matches_reference(cfg, seed):
    """B = 3, N = 4, K = 12: the port's hardened X is the reference's; the
    allocation is feasible, binary, owns every subcarrier once and gives
    every device one."""
    jcfg, tcfg = CONFIGS[cfg]
    pb, tp = _scenario(seed, batch=3)
    want = _jsolve_batch(pb, jcfg)
    got = solve_batch(tp, Weights.ones(), tcfg)
    np.testing.assert_array_equal(np_(got.alloc.X), np.asarray(want.alloc.X))
    assert got.trace.shape == want.trace.shape == (3, tcfg.outer_iters)
    X = np_(got.alloc.X)
    assert set(np.unique(X)) <= {0.0, 1.0}
    assert np.all(X.sum(axis=-2) == 1) and np.all(X.sum(axis=-1) >= 1)
    assert bool(feasible(tp, got.alloc).all())
    for leaf in ("f", "P", "rho"):
        assert np.all(np.isfinite(np_(getattr(got.alloc, leaf)))), leaf
    assert np.all(np.isfinite(np_(got.trace)))


#: how far the port's range of answers may lie outside the reference's, in
#: units of the reference's own spread, beyond the planned tolerance
SPREAD_FACTOR = 3.0


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_batch_continuous_leaves_within_reference_spread(cfg, seed):
    """The objective, f, rho and P of a whole solve, against the reference's
    own rounding noise (`torch_parity_spread`, ROADMAP.md §3): the reference
    solves the scenarios and five copies with every channel gain moved by
    one ulp, the port solves three of those inputs, and each leaf's range
    over the port's answers must overlap the reference's range (for the
    objective: must not lie above it), up to SPREAD_FACTOR times the
    reference's spread beyond the planned tolerance (objective rtol 1e-4, f
    and rho rtol 1e-3, P atol 1e-3 p_max). A port that is systematically
    worse, or off by more than the reference's own noise, fails here even
    with the right X."""
    res = leaf_spread(*CONFIGS[cfg], seed)
    for leaf, r in res.items():
        limit = r["planned"] + SPREAD_FACTOR * (r["hi"] - r["lo"])
        over = r["gap"] - limit
        worst = np.unravel_index(np.argmax(over), over.shape)
        assert np.all(over <= 0), (
            f"{leaf}{worst}: port {r['port'][(slice(None), *worst)]} vs reference "
            f"[{r['lo'][worst]}, {r['hi'][worst]}] beyond {np.broadcast_to(limit, over.shape)[worst]}")


# ---------------------------------------------------------------------------
# equivalence rows inside the port
# ---------------------------------------------------------------------------

CHEAP = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=40))


@pytest.fixture(scope="module")
def batch3():
    _, tp = _scenario(40, batch=3)
    return tp, solve_batch(tp, Weights.ones(), CHEAP)


def test_batch_equals_per_scenario(batch3):
    """A scenario's answer does not depend on the rest of its batch."""
    tp, res = batch3
    for b in range(3):
        one = solve(tree_index(tp, b), Weights.ones(), CHEAP)
        np.testing.assert_array_equal(np_(one.alloc.X), np_(res.alloc.X[b]))


def test_kernel_scoring_equals_plain_scoring(batch3):
    """`use_kernel_objective` routes the selection and the trace through the
    kernel path; the plain `system.objective` path selects the same
    allocation (tests/test_kernels.py:343)."""
    tp, res = batch3
    off = solve_batch(tp, Weights.ones(), CHEAP._replace(use_kernel_objective=False))
    for leaf in ("X", "P", "rho", "f"):
        np.testing.assert_array_equal(np_(getattr(off.alloc, leaf)), np_(getattr(res.alloc, leaf)))
    np.testing.assert_allclose(np_(off.trace), np_(res.trace), rtol=1e-5)


def test_padded_equals_exact():
    """A `pad_params`-padded scenario solves to the exact-shape hardened X on
    the real block, and leaves the padding unassigned."""
    p, tp = _scenario(21, N=3, K=7)
    exact = solve(tp, Weights.ones(), CHEAP)
    padded = solve(pad_params(tp, 4, 8), Weights.ones(), CHEAP)
    np.testing.assert_array_equal(np_(unpad_alloc(padded.alloc, 3, 7).X), np_(exact.alloc.X))
    assert float(padded.alloc.X[3:].sum()) == 0 and float(padded.alloc.X[:, 7:].sum()) == 0


def test_batched_weights_and_accuracy_equal_broadcast(batch3):
    """Uniform per-row weights and accuracy fits solve like the broadcast
    ones; mismatched leading axes are refused."""
    tp, res = batch3
    w = stack_weights([Weights.ones()] * 3)
    acc = stack_accuracy([default_accuracy()] * 3)
    got = solve_batch(tp, w, CHEAP, acc, weights_batched=True, acc_batched=True)
    np.testing.assert_array_equal(np_(got.alloc.X), np_(res.alloc.X))
    np.testing.assert_array_equal(np_(got.alloc.P), np_(res.alloc.P))
    with pytest.raises(ValueError, match="weights"):
        solve_batch(tp, Weights.ones(), CHEAP, weights_batched=True)
    with pytest.raises(ValueError, match="accuracy"):
        solve_batch(tp, Weights.ones(), CHEAP, stack_accuracy([default_accuracy()] * 2),
                    acc_batched=True)


def test_inner_auto_keeps_the_better_of_both(batch3):
    """``inner="auto"`` races SCA against PGD per scenario: its answer is
    the better of the two single-inner solves (SCA first on a tie)."""
    tp, _ = batch3
    cfg = CHEAP._replace(p5=P5Config(outer_iters=1, inner_iters=10))
    both = solve_batch(tp, Weights.ones(), cfg._replace(inner="auto"))
    sca = solve_batch(tp, Weights.ones(), cfg._replace(inner="sca"))
    pgd = solve_batch(tp, Weights.ones(), cfg._replace(inner="pgd"))
    w = Weights.ones()
    for b in range(3):
        alone = [tree_index(r.alloc, b) for r in (sca, pgd)]
        objs = [float(objective(tree_index(tp, b), w, a)) for a in alone]
        best = alone[int(np.argmin(objs))]
        np.testing.assert_array_equal(np_(both.alloc.X[b]), np_(best.X))
        np.testing.assert_array_equal(np_(both.alloc.P[b]), np_(best.P))


def test_unported_options_raise():
    tp = stack_params([_scenario(0)[1]])
    with pytest.raises(TypeError, match="mesh"):
        solve_batch(tp, Weights.ones(), CHEAP, mesh=object())
    with pytest.raises(ValueError, match="inner"):
        solve_batch(tp, Weights.ones(), CHEAP._replace(inner="newton"))
    with pytest.raises(ValueError, match=r"\(B, N, K\)"):
        solve_batch(tree_index(tp, 0), Weights.ones(), CHEAP)


def test_defaults_match_reference():
    """Same config defaults as the reference (6 outer iterations; P5 8 x 250;
    PGD 800 steps), so a default solve is the same amount of work."""
    assert AllocatorConfig()._asdict().keys() == JConfig()._asdict().keys()
    assert tuple(AllocatorConfig().p5) == tuple(JConfig().p5)
    assert tuple(AllocatorConfig().pgd) == tuple(JConfig().pgd)
    assert (AllocatorConfig().outer_iters, AllocatorConfig().inner) == (6, "sca")
