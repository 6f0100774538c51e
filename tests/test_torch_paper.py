"""The paper's drivers in the port (`repro_torch.paper`, the three examples
of `repro_torch.launch`) against the JAX reference, on the CPU.

* `db_to_linear` and `yolov3_accuracy` equal the reference's.
* The sweep helpers of `paper.common` on the same numpy scenarios as
  `repro.core`'s `solve_batch` / `report` / `feasible` / baselines (N 4,
  K 8, PGD 2 x 80): the hardened X is identical; each row is the
  reference's `report` of the port's allocation (float32 round-off); the
  continuous leaves lie within the reference's own one-ulp spread, by
  `tests/test_torch_allocator.py`'s law (ROADMAP.md §3).
* Each driver's claim checks on rows built by hand, passing and failing.
* Every driver and example end to end at a cut allocator depth, the
  runner, and the shared-seed sweep property.

No test imports the reference's ``benchmarks/`` package.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    Allocation as JAllocation, AllocatorConfig as JConfig, Weights as JWeights,
    solve_batch as jsolve_batch, stack_params as jstack, stack_weights as jstack_weights,
)
from repro.core import baselines as JB
from repro.core.accuracy import yolov3_accuracy as jyolov3
from repro.core.pgd import PGDConfig as JPGD
from repro.core.system import feasible as jfeasible, report as jreport
from repro.core.types import db_to_linear as jdb_to_linear
from repro_torch.core import AllocatorConfig, db_to_linear, tree_index, yolov3_accuracy
from repro_torch.core.p5 import P5Config
from repro_torch.core.exhaustive import solve_exhaustive
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.system import feasible
from repro_torch.launch import fedsem_autoencoder, quickstart, serve_scenarios
from repro_torch.paper import (
    alg_analysis, common, fig3_weights, fig4_pmax, fig5_users_subcarriers, fig6_workloads,
    fig8_accuracy, run as runner, table2_exhaustive,
)
from repro_torch.scenarios import list_families
from torch_parity_spread import ulp_inputs
from torch_port_util import both_params, np_, numpy_scenarios

torch.set_num_threads(1)

JCFG = JConfig(inner="pgd", outer_iters=2, pgd=JPGD(steps=80))
TCFG = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=80))
#: tests/test_torch_allocator.py's law: the planned tolerance (objective
#: rtol 1e-4, f and rho rtol 1e-3, P atol 1e-3 p_max) plus this many times
#: the reference's spread over one-ulp copies of the channel gains
SPREAD_FACTOR = 3.0
#: the drivers' depth end to end: the allocator's step structure, a few of
#: its steps (2 outer iterations: alg_analysis reads the trace's last two)
CUT = AllocatorConfig(outer_iters=2, p5=P5Config(outer_iters=1, inner_iters=20),
                      pgd=PGDConfig(steps=20))
REPORT_KEYS = ("objective", "energy_total", "energy_fl_tx", "energy_fl_comp", "energy_semcom",
               "t_fl", "t_sc_max_dev", "accuracy", "rho", "min_rate")

#: the reference's solve, compiled once: the weights-batched program (a
#: batch of uniform rows solves as the broadcast program does, the
#: reference's multi-tenant equivalence row)
_jsolve_w = jax.jit(lambda p, w: jsolve_batch(p, w, JCFG, weights_batched=True))
_jreport = jax.jit(jax.vmap(lambda p, w, a: {**jreport(p, w, a), "feasible": jfeasible(p, a)}))
_jcomm = jax.jit(lambda p: JB.comm_opt_only(p, JWeights.ones(), jax.random.PRNGKey(0)))


def _jweights(ws):
    return jstack_weights([JWeights(*(jnp.float32(k) for k in w)) for w in ws])


def _port_weights(w):
    return common.weights(*w, device="cpu")


def _jalloc(a):
    return JAllocation(*(jnp.asarray(np_(getattr(a, k))) for k in ("f", "P", "X", "rho")))


def _captured(fn):
    """(fn()'s value, (method, params, allocation) of every allocation the
    helpers made during it)."""
    seen = []
    with common.watch(lambda method, p, w, alloc, reps: seen.append((method, p, alloc))):
        out = fn()
    return out, seen


def _rows_are_reference_reports(rows, jp, jw, alloc):
    """Each row is the reference's report (and feasibility) of the port's
    allocation of that row, to float32 round-off."""
    want = _jreport(jp, jw, _jalloc(alloc))
    for i, row in enumerate(rows):
        for k in REPORT_KEYS:
            np.testing.assert_allclose(row[k], float(want[k][i]), rtol=1e-5, atol=1e-12, err_msg=k)
        assert row["feasible"] is bool(want["feasible"][i])
        assert row["runtime_s"] > 0.0


def _hold_to_reference_spread(arrays, meta, jw, jsolve, tsolve, first, members=6,
                              port_members=3):
    """The port's f, rho, P and objective (the reference's objective of
    each allocation, under the stacked weights ``jw``) over one-ulp copies
    of the channel gains, against the reference's range over more of them
    (SPREAD_FACTOR; the objective only where the port is worse). ``first``
    is the port's allocation of the unperturbed input."""
    ref, port = [], []
    for i, a in enumerate(ulp_inputs(arrays, members, 7)):
        jp, tp = both_params(a, meta)
        mine = [] if i >= port_members else [_jalloc(first if i == 0 else tsolve(tp))]
        allocs = [jsolve(jp)] + mine
        for out, al in zip((ref, port), allocs):
            out.append(dict(f=np.asarray(al.f), rho=np.asarray(al.rho), P=np.asarray(al.P),
                            obj=np.asarray(_jreport(jp, jw, al)["objective"])))
    for leaf in ("obj", "f", "rho", "P"):
        R, Q = np.stack([m[leaf] for m in ref]), np.stack([m[leaf] for m in port])
        lo, hi = R.min(0), R.max(0)
        if leaf == "P":
            planned = 1e-3 * arrays["p_max"][..., None]
        else:
            planned = (1e-4 if leaf == "obj" else 1e-3) * np.abs(R[0])
        above = np.maximum(Q.min(0) - hi, 0.0)
        gap = above if leaf == "obj" else np.maximum(above, np.maximum(lo - Q.max(0), 0.0))
        assert np.all(gap <= planned + SPREAD_FACTOR * (hi - lo)), leaf


# ---------------------------------------------------------------------------
# the two helpers of the reference's core
# ---------------------------------------------------------------------------


def test_db_to_linear_matches_reference():
    db = np.linspace(-30.0, 40.0, 71, dtype=np.float32)
    np.testing.assert_array_equal(np_(db_to_linear(db)), np.asarray(jdb_to_linear(db)))
    assert db_to_linear(3.0).dtype == torch.float32


def test_yolov3_accuracy_matches_reference():
    got, want = yolov3_accuracy(), jyolov3()
    assert float(got.a) == float(want.a) and float(got.b) == float(want.b)
    rho = np.linspace(0.05, 1.0, 20).astype(np.float32)
    np.testing.assert_array_equal(np_(got.value(rho)), np.asarray(want.value(rho)))
    np.testing.assert_array_equal(np_(got.deriv(rho)), np.asarray(want.deriv(rho)))


# ---------------------------------------------------------------------------
# the sweep helpers against repro.core
# ---------------------------------------------------------------------------


def test_run_proposed_batch_matches_reference():
    arrays, meta = numpy_scenarios(0, N=4, K=8, batch=3)
    jw = _jweights([(1.0, 1.0, 1.0)] * 3)

    def port(tp):
        return _captured(lambda: common.run_proposed_batch(
            tp, _port_weights((1.0, 1.0, 1.0)), "pgd", allocator=TCFG, device="cpu"))

    def ref(jp):
        return _jsolve_w(jp, jw).alloc

    jp, tp = both_params(arrays, meta)
    rows, ((method, _, res),) = port(tp)
    assert method == "proposed" and len(rows) == 3
    np.testing.assert_array_equal(np_(res.alloc.X), np.asarray(ref(jp).X))
    _rows_are_reference_reports(rows, jp, jw, res.alloc)
    _hold_to_reference_spread(arrays, meta, jw, ref, lambda p: port(p)[1][0][2].alloc, res.alloc)


def test_run_proposed_weights_batch_matches_reference():
    arrays, meta = numpy_scenarios(3, N=4, K=8)
    ws = [(1.0, 1.0, 1.0), (4.0, 1.0, 1.0), (1.0, 1.0, 5.0)]
    jw = _jweights(ws)
    jp, tp = both_params(arrays, meta)

    def port(tp_):
        return _captured(lambda: common.run_proposed_weights_batch(
            tp_, [_port_weights(w) for w in ws], "pgd", allocator=TCFG, device="cpu"))

    def ref(jp_):
        return _jsolve_w(jstack([jp_] * len(ws)), jw).alloc

    rows, ((_, _, res),) = port(tp)
    np.testing.assert_array_equal(np_(res.alloc.X), np.asarray(ref(jp).X))
    _rows_are_reference_reports(rows, jstack([jp] * len(ws)), jw, res.alloc)


def test_run_baselines_match_reference():
    jp, tp = both_params(*numpy_scenarios(2, N=4, K=8))
    w = _port_weights((1.0, 1.0, 1.0))
    jw = _jweights([(1.0, 1.0, 1.0)])
    rows, seen = _captured(lambda: common.run_baselines(tp, w, 0, device="cpu"))
    assert list(rows) == [m for m, _, _ in seen] == ["equal", "comm_only", "comp_only", "random"]
    allocs = {name: tree_index(alloc, 0) for name, _, alloc in seen}
    for name, (_, _, alloc) in zip(rows, seen):
        rows[name]["runtime_s"] = 1.0          # the baselines are not timed
        _rows_are_reference_reports([rows[name]], jstack([jp]), jw, alloc)
        assert float(alloc.rho) == 1.0
    # the deterministic baselines are the reference's, leaf for leaf
    for name, jalloc in (("equal", JB.equal_allocation(jp)),
                         ("comp_only", JB.comp_opt_only(jp, JWeights.ones()))):
        for leaf in ("f", "P", "X", "rho"):
            np.testing.assert_allclose(np_(getattr(allocs[name], leaf)),
                                       np.asarray(getattr(jalloc, leaf)), rtol=1e-6, err_msg=leaf)
    # comm_only: PGD's relaxed X hardens to the reference's
    np.testing.assert_array_equal(np_(allocs["comm_only"].X) > 0.5,
                                  np.asarray(_jcomm(jp).X) > 0.5)
    # random keeps the reference's law: f = 0.1 f_max, one owner a subcarrier
    np.testing.assert_array_equal(np_(allocs["random"].f), np.full(4, 2e8, np.float32))
    assert np.all(np_(allocs["random"].X).sum(0) == 1)


@pytest.mark.parametrize("family", list_families())
def test_sweep_points_share_their_draw(family):
    """Only the overrides move between the points of a sweep: every point
    of fig4's P_max sweep and fig6's payload sweep has the same channel
    gains and cycles."""
    for overrides in ([{"p_max_dbm": p} for p in fig4_pmax.PMAX_DBM],
                      [{"C_round_bits": 1e6 * m, "L_rounds": 10} for m in fig6_workloads.MULTIPLES]):
        points = common.sample_sweep(3, overrides, scenario=family, device="cpu", N=6, K=12)
        for p in points[1:]:
            assert torch.equal(p.g, points[0].g) and torch.equal(p.c, points[0].c)


# ---------------------------------------------------------------------------
# the claim checks on rows built by hand
# ---------------------------------------------------------------------------


def _fig3_rows(e1, t2, rho3, sc3):
    rows = []
    for which, field, (a, b) in (("kappa1", "energy_total", e1), ("kappa2", "t_fl", t2),
                                 ("kappa3", "rho", rho3), ("kappa3", "energy_semcom", sc3)):
        for i, v in enumerate((a, b)):
            row = next((r for r in rows if r["sweep"] == which and r["value"] == i), None)
            if row is None:
                row = {"sweep": which, "value": i, "energy_total": 1.0, "t_fl": 1.0, "rho": 0.5,
                       "energy_semcom": 1.0}
                rows.append(row)
            row[field] = v
    return rows


def _fig4_rows(prop_feasible=True, base_feasible=True, base_obj=-2.0, base_energy=2.0):
    rows = []
    for pmax in (16.0, 24.0):
        for method, obj, energy, feas in (
                ("proposed", -5.0, 1.0, prop_feasible), ("proposed_pgd", -4.0, 1.5, prop_feasible),
                ("equal", base_obj, base_energy, base_feasible), ("comm_only", -9.0, 2.5, False),
                ("comp_only", -1.0, 3.0, base_feasible), ("random", -1.0, 3.0, base_feasible)):
            rows.append({"pmax_dbm": pmax, "method": method, "objective": obj,
                         "energy_total": energy, "feasible": feas})
    return rows


def _fig5_rows(e_20, t_20, e_8):
    """The (N, K) grid (4, 8) x (20, 40) in the driver's order: energy and
    t_fl at K = 20 for N = 4, 8 (``e_20``, ``t_20``), energy at N = 8 for
    K = 20, 40 (``e_8``; its K = 20 entry is ``e_20[1]``)."""
    energy = {(4, 20): e_20[0], (8, 20): e_20[1], (8, 40): e_8}
    t_fl = {(4, 20): t_20[0], (8, 20): t_20[1]}
    return [{"N": n, "K": k, "energy_total": energy.get((n, k), 1.0), "t_fl": t_fl.get((n, k), 1.0)}
            for n in (4, 8) for k in (20, 40)]


def _table2_rows(ex, years):
    return [{"method": "equal", "objective": -1.0}, {"method": "proposed(sca)", "objective": -5.0},
            {"method": "proposed(pgd)", "objective": -4.0},
            {"method": "approx_exhaustive", "objective": ex},
            {"method": "exhaustive@N=10,K=50 (projected)", "objective": float("nan"),
             "runtime_s": years * table2_exhaustive.YEAR_S}]


def _alg_rows(last_step, times):
    rows = [{"kind": "trace", "seed": s, "s0": -1.0, "s1": -4.0, "s2": -4.0 - last_step}
            for s in range(3)]
    return rows + [{"kind": "runtime", "N": n, "K": k, "NK": n * k, "runtime_s": t}
                   for (n, k), t in zip(((4, 12), (8, 24)), times)]


CHECK_CASES = {
    # driver: (rows that pass every check, rows that fail, the checks that fail)
    "fig3": (fig3_weights, _fig3_rows((2.0, 1.0), (3.0, 1.0), (0.3, 0.5), (1.0, 1.2)),
             _fig3_rows((1.0, 2.0), (1.0, 2.0), (0.5, 0.3), (1.0, 0.5)),
             {"k1_energy_down", "k2_time_down", "k3_rho_up", "k3_semcom_up"}),
    "fig4": (fig4_pmax, _fig4_rows(), _fig4_rows(base_obj=-6.0, base_energy=0.9),
             {"beats_baselines@16.0dBm", "beats_baselines@24.0dBm",
              "lowest_energy@16.0dBm", "lowest_energy@24.0dBm"}),
    "fig4_infeasible": (fig4_pmax, _fig4_rows(), _fig4_rows(prop_feasible=False),
                        {"beats_baselines@16.0dBm", "beats_baselines@24.0dBm"}),
    "fig5": (fig5_users_subcarriers, _fig5_rows((1.0, 2.0), (1.0, 2.0), 1.5),
             _fig5_rows((2.0, 1.0), (2.0, 1.0), 2.0),
             {"energy_up_with_users", "tfl_up_with_users", "energy_down_with_subcarriers"}),
    "fig6": (fig6_workloads,
             [{"workload_multiple": m, "energy_semcom": e} for m, e in ((1.0, 1.0), (4.0, 2.0), (-1.0, 0.1))],
             [{"workload_multiple": m, "energy_semcom": e} for m, e in ((1.0, 2.0), (4.0, 1.0), (-1.0, 9.0))],
             {"semcom_energy_up_with_workload"}),
    "fig8": (fig8_accuracy,
             [{"kappa3": k, "rho": r} for k, r in ((0.2, 0.3), (1.0, 0.5))]
             + [{"rho": r, "yolov5_fit": a} for r, a in ((0.1, 0.2), (0.5, 0.5))],
             [{"kappa3": k, "rho": r} for k, r in ((0.2, 0.5), (1.0, 0.3))]
             + [{"rho": r, "yolov5_fit": a} for r, a in ((0.1, 0.5), (0.5, 0.5))],
             {"rho_nondecreasing_in_k3", "accuracy_concave_increasing"}),
    "table2": (table2_exhaustive, _table2_rows(-5.5, 1e9), _table2_rows(-9.0, 10.0),
               {"exhaustive_not_much_better", "exhaustive_intractable_at_scale"}),
    "alg_analysis": (alg_analysis, _alg_rows(0.01, (1.0, 2.0)), _alg_rows(3.0, (1.0, 40.0)),
                     {"all_traces_converge", "runtime_subquadratic_in_NK"}),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_checks_on_hand_built_rows(case):
    mod, good, bad, failing = CHECK_CASES[case]
    passed = mod.checks(good)
    assert all(v is True for v in passed.values()), passed
    got = mod.checks(bad)
    assert set(got) == set(passed)
    assert {k for k, v in got.items() if v is False} == failing, got


def test_fig4_skips_the_comparison_without_a_feasible_baseline():
    got = fig4_pmax.checks(_fig4_rows(base_feasible=False))
    assert got["beats_baselines@16.0dBm"] == "skipped (no feasible baseline)"
    assert got["lowest_energy@16.0dBm"] is True
    # the runner counts a skip as neither a pass nor a failure
    assert runner.print_checks({"fig4_pmax": got}) == 0


# ---------------------------------------------------------------------------
# every driver and example end to end, at a cut depth
# ---------------------------------------------------------------------------

#: each driver's row keys (besides the report's) and check names, as the reference's
DRIVER_SHAPES = {
    "fig3_weights": ({"sweep", "value"}, {"k1_energy_down", "k2_time_down", "k3_rho_up",
                                          "k3_semcom_up"}),
    "fig4_pmax": ({"pmax_dbm", "method"}, {"beats_baselines@16.0dBm", "lowest_energy@16.0dBm",
                                           "beats_baselines@24.0dBm", "lowest_energy@24.0dBm"}),
    "fig5_users_subcarriers": ({"N", "K", "n_realisations"},
                               {"energy_up_with_users", "tfl_up_with_users",
                                "energy_down_with_subcarriers"}),
    "fig6_workloads": ({"workload_multiple"}, {"semcom_energy_up_with_workload"}),
    "fig8_accuracy": ({"kappa3"}, {"rho_nondecreasing_in_k3", "accuracy_concave_increasing"}),
    "table2_exhaustive": ({"method", "objective", "runtime_s"},
                          {"exhaustive_not_much_better", "proposed_beats_equal",
                           "exhaustive_intractable_at_scale"}),
    "alg_analysis": ({"kind"}, {"all_traces_converge", "runtime_subquadratic_in_NK"}),
}


def _small_exhaustive(params, w, f_levels, p_levels_dbm, rho_levels):
    """Table II's oracle on 2 frequency and 1 power level (the quick grid's
    first ones), so that its plain sweep takes a second on the CPU."""
    return solve_exhaustive(params, w, f_levels[:2], p_levels_dbm[:1], rho_levels)


@pytest.mark.parametrize("name", sorted(DRIVER_SHAPES))
def test_driver_runs_end_to_end(name, tmp_path, monkeypatch):
    mod = runner.DRIVERS[name]
    monkeypatch.setattr(table2_exhaustive, "solve_exhaustive", _small_exhaustive)
    (rows, checks), seen = _captured(lambda: mod.run(quick=True, device="cpu", allocator=CUT,
                                                     out_dir=tmp_path))
    keys, names = DRIVER_SHAPES[name]
    assert set(checks) == names
    assert all(isinstance(v, bool) or v == "skipped (no feasible baseline)" for v in checks.values())
    assert all(keys <= set(r) for r in rows if "yolov5_fit" not in r and r.get("kind") != "trace")
    solves = [(p, a.alloc) for m, p, a in seen if m == "proposed"]
    assert solves and all(bool(feasible(p, a).all()) for p, a in solves)
    assert all(np.isfinite(r["objective"]) for r in rows if "objective" in r
               and "projected" not in str(r.get("method")))
    written = sorted(tmp_path.glob("*.csv"))
    assert written and sum(len(list(csv.DictReader(open(p)))) for p in written) == len(rows)


class _Quick:
    """A driver that returns at once: one row, one passing claim."""

    @staticmethod
    def run(quick=True, device="cuda", **kw):
        return [{"value": 1.0}], {"holds": True, "fails": False}


class _Broken:
    @staticmethod
    def run(**kw):
        raise FloatingPointError("a driver failed")


def test_runner_prints_each_driver_and_stops_on_a_raise(capsys, monkeypatch):
    monkeypatch.setattr(runner, "DRIVERS", {"fig1_quick": _Quick, "fig9_broken": _Broken})
    assert runner.main(["--only", "fig1", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines()[1].startswith("fig1_quick,") and "checks=1/2" in out
    assert "fig1_quick.holds: PASS" in err and "1 claim-check failure(s)" in err
    with pytest.raises(FloatingPointError):
        runner.main(["--device", "cpu"])
    out, err = capsys.readouterr()
    assert "fig1_quick," in out and "fig1_quick.fails: FAIL" in err
    with pytest.raises(SystemExit):
        runner.main(["--only", "nothing"])


def test_entry_points_default_to_the_card():
    """With no card, a driver or example called without ``device="cpu"``
    raises instead of moving to the CPU."""
    assert not torch.cuda.is_available()
    for call in (lambda: fig8_accuracy.run(), lambda: quickstart.run(),
                 lambda: runner.main(["--only", "fig3"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_examples_run_end_to_end(tmp_path):
    params, res, rows = quickstart.run("cpu", CUT)
    assert list(rows) == ["proposed (Alg. A2)", "equal", "comm-only", "comp-only", "random"]
    assert res.trace.shape == (CUT.outer_iters,)
    assert bool(torch.isfinite(torch.stack([r["objective"] for r in rows.values()])).all())

    requests, result = serve_scenarios.run("cpu", CUT._replace(inner="pgd"))
    assert sorted(c.req_id for c in result.completions) == list(range(8))
    assert {(p.N, p.K) for p in requests} <= {(3, 8), (4, 8), (4, 12)}

    rows, fit = fedsem_autoencoder.run(1, (0.3, 1.0), "cpu", tmp_path, CUT._replace(inner="pgd"))
    assert [r["rho"] for r in rows] == [0.3, 1.0]
    assert all(np.isfinite(r["psnr_db"]) and 0.0 <= r["proxy_accuracy"] <= 1.0 for r in rows)
    assert 0.05 <= float(fit.b) <= 0.95
    saved = list(csv.DictReader(open(tmp_path / "ae_accuracy.csv")))
    assert [float(r["rho"]) for r in saved] == [0.3, 1.0]
    assert (tmp_path / "ae_accuracy_fit.csv").read_text().startswith("a,b\n")
