"""The FedSem system model (paper eqs. 1-13) and Theorem 1, in NumPy float64:
the plain reference that judges an allocation.

It does not re-run the solver (its continuous leaves are chaotic at the ulp
level, ROADMAP §3). It checks what an allocation must satisfy and works out
again what the program derived from it:

* feasibility of P1's constraints (13a)-(13g) and of the hardened X (binary,
  a subcarrier to at most one device, every device at least one), each
  within a relative slack ``tol``;
* eq. 13 of the returned allocation, against the objective the program's
  scoring path reported;
* Theorem 1's rho given the returned (P, X) (eq. 24 in closed form: all
  devices share one accuracy fit A(rho) = a rho^b, so Delta(rho) = 0 gives
  rho = (cost / (kappa3 n a b))^(1 / (b - 1)), then the deadline's clip);
* what Alg. A2 minimises, eq. 13, against a plain allocation worked out
  here, the equal split: the median over the batch of the answer's
  objective over the equal split's. The solver need not beat the equal
  split (at a large FL upload it trades T_FL for energy), but a solver
  whose steps lose their gradient leaves it tens of times worse;
* whether the solver moved at all: the share of scenarios answered with
  the round-robin subcarrier split, the solver's own start, which a sound
  solve on Rayleigh-faded subcarriers all but never returns;
* as diagnostics, the quartiles of the objective and the energy against
  the equal split (round-robin subcarriers, each device's budget spread
  evenly, (f, rho) by Theorem 1), and f against Theorem 1's f given (P, X)
  (eqs. 28-29, by bisection on T).

Scenarios are dicts of arrays as `scenarios.draw` makes them, every device
real (no padding).
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-12
_RHO_LO = 1e-4


def as_numpy(sc: dict) -> dict:
    """A scenario batch with float64 NumPy arrays in place of tensors."""
    out = {}
    for k, v in sc.items():
        out[k] = v.detach().cpu().double().numpy() if hasattr(v, "detach") else v
    return out


def bbar(sc):
    return sc["B"] / sc["K"]


def subcarrier_rate(sc, P):
    """r_{n,k} = Bbar log2(1 + p g / (N0 Bbar)), eq. 1."""
    noise = sc["N0"] * bbar(sc)
    return bbar(sc) * np.log2(1.0 + P * sc["g"] / noise)


def device_rate(sc, P, X):
    """r_n = sum_k x_{n,k} r_{n,k}, eq. 2."""
    return np.sum(X * subcarrier_rate(sc, P), axis=-1)


def terms(sc, f, P, X, rho, acc):
    """Eq. 13's three terms per scenario: (sum_n E^t + E^c + E^sc, T_FL,
    sum_n A(rho))."""
    a, b = acc
    r = np.maximum(device_rate(sc, P, X), _EPS)
    p_n = np.sum(P, axis=-1)
    tau = sc["D"] / r                                         # eq. 4
    e_t = p_n * tau                                           # eq. 5
    eta_cd = sc["eta"] * sc["c"] * sc["d"]
    t_c = eta_cd / np.maximum(f, _EPS)                        # eq. 6
    e_c = sc["xi"] * eta_cd * f**2                            # eq. 7
    t_sc = rho[..., None] * sc["C"] / r                       # eq. 10
    e_sc = p_n * t_sc                                         # eq. 12
    t_fl = np.max(tau + t_c, axis=-1)                         # eq. 8
    acc_sum = sc["g"].shape[-2] * a * np.maximum(rho, 1e-9) ** b
    return np.sum(e_t + e_c + e_sc, axis=-1), t_fl, acc_sum


def objective(sc, f, P, X, rho, kappa, acc):
    """Eq. 13: kappa1 sum_n (E^t + E^c + E^sc) + kappa2 T_FL - kappa3 sum_n A(rho)."""
    energy, t_fl, acc_sum = terms(sc, f, P, X, rho, acc)
    return kappa[0] * energy + kappa[1] * t_fl - kappa[2] * acc_sum


def theorem1_rho(sc, P, X, kappa, acc):
    """rho* given (P, X): eq. 24's root in closed form, clipped to
    [1e-4, rho_max], rho_max = min(1, min_n T^sc_max r_n / C_n)."""
    k1, _, k3 = kappa
    a, b = acc
    n = sc["g"].shape[-2]
    r = np.maximum(device_rate(sc, P, X), _EPS)
    cost = np.sum(k1 * np.sum(P, axis=-1) * sc["C"] / r, axis=-1)
    with np.errstate(divide="ignore", over="ignore"):
        root = (cost / (k3 * n * a * b)) ** (1.0 / (b - 1.0))
    root = np.clip(np.nan_to_num(root, nan=1.0, posinf=1.0), _RHO_LO, 1.0)
    rho_max = np.minimum(np.min(sc["t_sc_max"] * r / np.maximum(sc["C"], 1e-30), axis=-1), 1.0)
    return np.clip(np.minimum(root, rho_max), _RHO_LO, 1.0)


def theorem1_f(sc, P, X, kappa, iters: int = 200):
    """f* given (P, X): T# solves sum_n 2 kappa1 xi f_n(T)^3 = kappa2 with
    f_n(T) = min(eta c_n d_n / (T - tau_n), f_max) (eq. 28) by bisection,
    then f* = f(T#) (eq. 29)."""
    k1, k2, _ = kappa
    r = np.maximum(device_rate(sc, P, X), _EPS)
    tau = sc["D"] / r
    eta_cd = sc["eta"] * sc["c"] * sc["d"]
    f_of = lambda T: np.minimum(eta_cd / np.maximum(T[..., None] - tau, 1e-9), sc["f_max"])
    F = lambda T: np.sum(2.0 * k1 * sc["xi"] * f_of(T) ** 3, axis=-1) - k2
    lo = np.max(tau + eta_cd / sc["f_max"], axis=-1)
    hi = 2.0 * lo + 1.0
    for _ in range(200):
        hi = np.where(F(hi) > 0.0, 2.0 * hi, hi)
    a, b = lo.copy(), hi
    for _ in range(iters):
        mid = 0.5 * (a + b)
        pos = F(mid) > 0.0
        a, b = np.where(pos, mid, a), np.where(pos, b, mid)
    T = np.where(F(lo) <= 0.0, lo, 0.5 * (a + b))
    return f_of(T)


def equal_split(sc, kappa, acc):
    """The equal split: subcarrier k to device k mod N, each device's p_max
    spread evenly over its subcarriers, (f, rho) by Theorem 1."""
    X = round_robin(sc["g"].shape).copy()
    P = X * sc["p_max"][..., None] / np.sum(X, axis=-1, keepdims=True)
    return theorem1_f(sc, P, X, kappa), P, X, theorem1_rho(sc, P, X, kappa, acc)


def infeasible(sc, f, P, X, rho, tol: float) -> np.ndarray:
    """Per scenario, whether any of (13a)-(13g) or the hardening's promises
    fails: X binary, a subcarrier to at most one device, every device at
    least one; P >= 0 and 0 off X; sum_k P <= p_max; 0 < f <= f_max; 0 < rho
    <= 1; rho C / r <= T^sc_max; every leaf finite. The bounds within a
    relative slack ``tol``."""
    finite = (np.isfinite(f).all(-1) & np.isfinite(P).all((-2, -1))
              & np.isfinite(X).all((-2, -1)) & np.isfinite(rho))
    binary = ((X == 0.0) | (X == 1.0)).all((-2, -1))
    owners = np.sum(X, axis=-2)
    one_owner = (owners <= 1.0).all(-1)
    served = (np.sum(X, axis=-1) >= 1.0).all(-1)
    power = (P >= 0.0).all((-2, -1)) & ((X != 0.0) | (P == 0.0)).all((-2, -1))
    budget = (np.sum(P, axis=-1) <= sc["p_max"] * (1 + tol)).all(-1)
    freq = ((f > 0.0) & (f <= sc["f_max"] * (1 + tol))).all(-1)
    rate = (rho > 0.0) & (rho <= 1.0 + tol)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = device_rate(sc, np.where(np.isfinite(P), P, 0.0), np.where(np.isfinite(X), X, 0.0))
        deadline = (rho[..., None] * sc["C"] / r <= sc["t_sc_max"] * (1 + tol)).all(-1)
    return ~(finite & binary & one_owner & served & power & budget & freq & rate & deadline)


def round_robin(shape) -> np.ndarray:
    """The round-robin assignment X (subcarrier k to device k mod N)."""
    Bt, N, K = shape
    return np.broadcast_to((np.arange(K)[None, :] % N == np.arange(N)[:, None]).astype(float),
                           (Bt, N, K))


def judge(sc, alloc: dict, reported, kappa, acc, tol: float) -> dict:
    """The numbers an allocation batch is held to (module docstring):
    ``infeasible`` (scenarios), ``objective_gap`` and ``rho_gap`` (the
    largest relative gaps), ``objective_ratio`` (the median of the objective
    over the equal split's), ``unmoved_share`` (the share answered with the
    round-robin split); and as diagnostics ``f_gap`` (the largest relative
    gap of f to Theorem 1's), the quartiles of 1 - objective / the equal
    split's and of energy / the equal split's, and the shares whose
    objective or energy is not below the equal split's."""
    f, P, X, rho = (np.asarray(alloc[k], dtype=np.float64) for k in ("f", "P", "X", "rho"))
    bad = infeasible(sc, f, P, X, rho, tol)
    with np.errstate(all="ignore"):
        obj = objective(sc, f, P, X, rho, kappa, acc)
        rep = np.asarray(reported, dtype=np.float64)
        obj_gap = np.abs(rep - obj) / np.maximum(np.abs(obj), _EPS)
        rho_ref = theorem1_rho(sc, P, X, kappa, acc)
        rho_gap = np.abs(rho - rho_ref) / rho_ref
        f_ref = theorem1_f(sc, P, X, kappa)
        f_gap = np.abs(f - f_ref) / f_ref
        eq = equal_split(sc, kappa, acc)
        base = objective(sc, *eq, kappa, acc)
        ratio = obj / base
        energy = terms(sc, f, P, X, rho, acc)[0] / terms(sc, *eq, acc)[0]
    worst = lambda x: float(np.max(np.where(np.isfinite(x), x, np.inf)))
    quartiles = lambda x: [float(q) for q in np.nanquantile(x, [0.0, 0.25, 0.5, 0.75, 1.0])]
    return {
        "infeasible": int(np.sum(bad)),
        "objective_gap": worst(obj_gap),
        "rho_gap": worst(rho_gap),
        "objective_ratio": float(np.median(np.where(np.isfinite(ratio), ratio, np.inf))),
        "unmoved_share": float(np.mean((X == round_robin(X.shape)).all((-2, -1)))),
        "gain_quartiles": quartiles(1.0 - ratio),
        "energy_ratio_quartiles": quartiles(energy),
        "not_below_equal_share": float(np.mean(~(obj < base))),
        "energy_not_below_equal_share": float(np.mean(~(energy < 1.0))),
        "rho_below_1_share": float(np.mean(rho_ref < 1.0)),
        "f_gap": worst(f_gap),
    }
