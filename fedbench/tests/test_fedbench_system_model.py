"""The system model that judges an allocation, on allocations worked out by
hand and on the properties Theorem 1 promises."""
from __future__ import annotations

import numpy as np
import pytest

from fedbench.yardstick import system_model as sm

KAPPA, ACC = (1.0, 1.0, 1.0), (1.0, 0.5)


def two_by_two():
    """Two devices, two subcarriers, Bbar = 1 Hz and N0 Bbar = 1 W, so
    r_nk = log2(1 + p g)."""
    sc = dict(g=np.array([[[3.0, 0.0], [0.0, 1.0]]]), c=np.ones((1, 2)), d=2 * np.ones((1, 2)),
              D=4 * np.ones((1, 2)), C=2 * np.ones((1, 2)), p_max=4 * np.ones((1, 2)),
              f_max=2 * np.ones((1, 2)), t_sc_max=10 * np.ones((1, 2)),
              N=2, K=2, B=2.0, N0=1.0, xi=0.5, eta=1, q=2)
    alloc = dict(f=np.ones((1, 2)), P=np.array([[[1.0, 0.0], [0.0, 3.0]]]),
                 X=np.eye(2)[None], rho=np.array([0.5]))
    return sc, alloc


def test_objective_by_hand():
    # rates 2 and 2 bit/s; tau = 2 s, t_c = 2 s; E = (2 + 1 + 0.5) + (6 + 1 + 1.5);
    # T_FL = 4 s; A = 2 * 0.5 ** 0.5
    sc, a = two_by_two()
    assert sm.device_rate(sc, a["P"], a["X"]) == pytest.approx(np.array([[2.0, 2.0]]))
    energy, t_fl, acc = sm.terms(sc, a["f"], a["P"], a["X"], a["rho"], ACC)
    assert (energy[0], t_fl[0], acc[0]) == pytest.approx((12.0, 4.0, 2 * 0.5**0.5))
    obj = sm.objective(sc, a["f"], a["P"], a["X"], a["rho"], KAPPA, ACC)
    assert obj[0] == pytest.approx(16.0 - 2 * 0.5**0.5)


def test_theorem1_rho_by_hand():
    # cost = 1 * 2 / 2 + 3 * 2 / 2 = 4; Delta(rho) = 4 - 2 * 0.5 * rho^-0.5 = 0 at 1/16
    sc, a = two_by_two()
    assert sm.theorem1_rho(sc, a["P"], a["X"], KAPPA, ACC)[0] == pytest.approx(1 / 16)
    tight = dict(sc, t_sc_max=0.01 * np.ones((1, 2)))            # the deadline clips it
    assert sm.theorem1_rho(tight, a["P"], a["X"], KAPPA, ACC)[0] == pytest.approx(0.01)


def random_batch(seed, B=64, N=4, K=12):
    rng = np.random.default_rng(seed)
    sc = dict(g=rng.exponential(size=(B, N, K)) * 1e-11, c=rng.uniform(1e4, 3e4, (B, N)),
              d=500 * np.ones((B, N)), D=rng.uniform(1e5, 1e11, (B, 1)) * np.ones((B, N)),
              C=4.15e7 * np.ones((B, N)), p_max=0.1 * np.ones((B, N)), f_max=2e9 * np.ones((B, N)),
              t_sc_max=20 * np.ones((B, N)), N=N, K=K, B=20e6, N0=10 ** -20.4, xi=1e-28, eta=10, q=2)
    X = sm.round_robin((B, N, K)).copy()
    P = X * rng.uniform(0.001, 0.1 / K, (B, N, K))
    return sc, P, X


@pytest.mark.parametrize("seed", [0, 1])
def test_theorem1_rho_solves_eq_24(seed):
    """The closed form against a bisection of Delta(rho) on [1e-4, 1]."""
    sc, P, X = random_batch(seed)
    rho = sm.theorem1_rho(sc, P, X, KAPPA, (0.6356, 0.4025))
    r = sm.device_rate(sc, P, X)
    cost = np.sum(P.sum(-1) * sc["C"] / r, -1)
    delta = lambda x: cost - X.shape[1] * 0.6356 * 0.4025 * x ** (0.4025 - 1)
    lo, hi = np.full_like(cost, 1e-4), np.ones_like(cost)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        up = delta(mid) > 0
        lo, hi = np.where(up, lo, mid), np.where(up, mid, hi)
    root = np.where(delta(1e-4) >= 0, 1e-4, np.where(delta(1.0) <= 0, 1.0, 0.5 * (lo + hi)))
    rho_max = np.minimum(np.min(sc["t_sc_max"] * r / sc["C"], -1), 1.0)
    assert rho == pytest.approx(np.clip(np.minimum(root, rho_max), 1e-4, 1.0), rel=1e-9)


def test_theorem1_f_minimises_the_objective_over_f():
    sc, P, X = random_batch(2, B=16)
    rho = sm.theorem1_rho(sc, P, X, KAPPA, ACC)
    f = sm.theorem1_f(sc, P, X, KAPPA)
    best = sm.objective(sc, f, P, X, rho, KAPPA, ACC)
    assert (f <= sc["f_max"]).all() and (f > 0).all()
    for scale in (0.99, 1.01):
        moved = np.minimum(f * scale, sc["f_max"])
        assert (sm.objective(sc, moved, P, X, rho, KAPPA, ACC) >= best * (1 - 1e-12)).all()


BROKEN = {
    "X not binary": lambda a: a["X"].__setitem__((0, 0, 0), 0.5),
    "a subcarrier to two devices": lambda a: a["X"].__setitem__((0, 1, 0), 1.0),
    "a device without a subcarrier": lambda a: (a["X"].__setitem__((0, 1, 1), 0.0),
                                                a["P"].__setitem__((0, 1, 1), 0.0)),
    "power off X": lambda a: a["P"].__setitem__((0, 0, 1), 0.1),
    "power over budget": lambda a: a["P"].__setitem__((0, 1, 1), 4.1),
    "negative power": lambda a: a["P"].__setitem__((0, 0, 0), -0.1),
    "f over f_max": lambda a: a["f"].__setitem__((0, 0), 2.01),
    "f zero": lambda a: a["f"].__setitem__((0, 0), 0.0),
    "rho over 1": lambda a: a["rho"].__setitem__(0, 1.01),
    "deadline missed": lambda a: a["rho"].__setitem__(0, 1.0) or a["P"].__setitem__((0, 0, 0), 1e-6),
    "not finite": lambda a: a["f"].__setitem__((0, 1), np.nan),
}


def test_a_sound_allocation_is_feasible():
    sc, a = two_by_two()
    assert not sm.infeasible(sc, a["f"], a["P"], a["X"], a["rho"], 1e-4)[0]


@pytest.mark.parametrize("fault", sorted(BROKEN))
def test_each_broken_constraint_is_infeasible(fault):
    sc, a = two_by_two()
    sc = dict(sc, t_sc_max=np.full((1, 2), 0.6))
    a = {k: v.copy() for k, v in a.items()}
    BROKEN[fault](a)
    assert sm.infeasible(sc, a["f"], a["P"], a["X"], a["rho"], 1e-4)[0]


def test_judge_reads_the_reported_objective_and_the_start():
    sc, P, X = random_batch(3, B=8)
    rho = sm.theorem1_rho(sc, P, X, KAPPA, ACC)
    f = sm.theorem1_f(sc, P, X, KAPPA)
    obj = sm.objective(sc, f, P, X, rho, KAPPA, ACC)
    got = sm.judge(sc, dict(f=f, P=P, X=X, rho=rho), obj * (1 + 1e-3), KAPPA, ACC, 1e-4)
    assert got["infeasible"] == 0 and got["rho_gap"] == 0.0
    assert got["objective_gap"] == pytest.approx(1e-3)
    assert got["unmoved_share"] == 1.0                 # round robin: the solver's start
    X2 = X.copy()
    X2[:, :, 0] = np.roll(X2[:, :, 0], 1, axis=1)       # subcarrier 0 to the next device
    assert sm.judge(sc, dict(f=f, P=P * X2, X=X2, rho=rho), obj, KAPPA, ACC, 1e-4)["unmoved_share"] == 0.0
