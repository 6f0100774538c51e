"""The program's spans and counters (`repro_torch.spans`) on the CPU.

They record only under a torch profiler session: without one the store
stays empty and makes no event. Under one, a `solve_batch` and a `prefill`
each give one request whose tree is Alg. A2's phases and the model's
sublayers, with the solver-step counter, and the answers are
bit for bit those of a run without spans. A fake clock that times the CPU
stands in for the card's events, so the device-interval bookkeeping
(events shared between adjacent spans, resolved when read) runs here too.
"""
import time

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import registry
from repro_torch.core import AllocatorConfig, Weights, batch_objectives, sample_params_batch, solve_batch
from repro_torch.core.p5 import P5Config
from repro_torch.core.pgd import PGDConfig, power_given_x, solve_p4_pgd
from repro_torch.models import model as M
from repro_torch.models.config import smoke_variant

CPU = [torch.profiler.ProfilerActivity.CPU]
B, OUTER, STEPS, POWER_STEPS = 3, 2, 6, 600


class FakeEvent:
    def __init__(self):
        self.t = time.time_ns()


class FakeClock:
    """Events stamped with the host clock, on any device."""

    def __init__(self):
        self.made = 0

    @staticmethod
    def stream(device):
        return device

    def record(self, stream):
        self.made += 1
        return FakeEvent()

    @staticmethod
    def anchor(stream):
        ev = FakeEvent()
        return ev.t, ev

    @staticmethod
    def elapsed_ns(a, b):
        return b.t - a.t


@pytest.fixture
def store(monkeypatch):
    """A fresh store behind the module's functions, on the fake clock."""
    st = spans.Store(clock=FakeClock())
    monkeypatch.setattr(spans, "STORE", st)
    return st


def _solve(inner="pgd"):
    params = sample_params_batch(5, B, device="cpu")
    cfg = AllocatorConfig(inner=inner, outer_iters=OUTER, pgd=PGDConfig(steps=STEPS),
                          p5=P5Config(outer_iters=2, inner_iters=10))
    w = Weights(1.0, 1.0, 1.0)
    res = solve_batch(params, w, cfg)
    return res, batch_objectives(params, w, res.alloc)


def _model(arch):
    cfg = smoke_variant(registry.get_config(arch)).scaled(n_layers=3)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 24), generator=torch.Generator().manual_seed(1))
    return cfg, params, {"tokens": toks}


def _children(snap, parent):
    return [s for s in snap["spans"] if s["parent"] == parent]


def test_nothing_is_recorded_without_a_profiler(store):
    torch.set_num_threads(1)
    _solve()
    cfg, params, batch = _model("rwkv6_1_6b")
    M.prefill(params, cfg, batch)
    snap = spans.snapshot()
    assert snap == {"spans": [], "counters": {}, "dropped": 0}
    assert store.clock.made == 0


def test_spans_outside_a_request_record_nothing(store):
    params = sample_params_batch(5, B, device="cpu")
    P = params.p_max[..., None] * torch.full((B, params.N, params.K), 0.02)
    X = torch.full((B, params.N, params.K), 1.0 / params.N)
    rmin = torch.full((B, params.N), 1e3)
    payload = params.D + params.C
    cfg, lm, batch = _model("starcoder2_3b")
    with torch.profiler.profile(activities=CPU):
        solve_p4_pgd(params, 1.0, payload, rmin, P, X, PGDConfig(steps=2))
        power_given_x(params, 1.0, payload, rmin, (X > 0.05).float(), steps=2)
        M.loss_fn(lm, cfg, dict(batch, labels=batch["tokens"]))     # training opens no request
        spans.count("adam_steps", 5)
    assert spans.snapshot()["spans"] == [] and store.clock.made == 0


@pytest.mark.parametrize("inner", ["pgd", "sca"])
def test_solve_batch_gives_alg_a2s_tree_and_bit_identical_answers(store, inner):
    torch.set_num_threads(1)
    plain, plain_obj = _solve(inner)
    with torch.profiler.profile(activities=CPU):
        traced, traced_obj = _solve(inner)
    for k in ("f", "P", "X", "rho"):
        assert torch.equal(getattr(plain.alloc, k), getattr(traced.alloc, k)), k
    assert torch.equal(plain.trace, traced.trace) and torch.equal(plain_obj, traced_obj)

    snap = spans.snapshot()
    roots = [s for s in snap["spans"] if s["parent"] is None]
    assert [r["name"] for r in roots] == ["solve_batch", "score"]      # batch_objectives its own
    solve, score = roots
    assert solve["attrs"]["B"] == B and solve["attrs"]["rows"] == 3 * B and score["attrs"]["rows"] == B
    step2 = "pgd" if inner == "pgd" else "p5"
    assert [s["name"] for s in _children(snap, solve["id"])] == (
        ["starts"] + ["p3", step2, "repair", "score"] * OUTER
        + ["harden_x", "p3", "power_given_x", "repair", "p3", "select"])
    starts = _children(snap, solve["id"])[0]
    assert [s["name"] for s in _children(snap, starts["id"])] == ["pgd"]
    # a first child opens on its own event: the equal and low-power starts
    # before the full-payload start's `pgd` are not its work
    assert _children(snap, starts["id"])[0]["device"][0] > starts["device"][0]
    assert all(s["root"] == solve["id"] for s in snap["spans"] if s is not score)
    assert _children(snap, score["id"]) == []

    pgd_calls = OUTER + 1 if inner == "pgd" else 1
    assert snap["counters"] == {"adam_steps": (pgd_calls - 1) * STEPS + STEPS + POWER_STEPS}
    for s in snap["spans"]:
        assert s["host"][0] <= s["host"][1]
        assert s["attrs"]["objective_launches"] == 0                   # the plain scoring on the CPU
        assert s["attrs"]["p4_adam_launches"] == 0                     # the eager Adam loops
        if s["name"] in ("pgd", "power_given_x"):                      # the innermost span's
            assert s["attrs"]["adam_steps"] == s["attrs"]["steps"]
            assert s["attrs"]["rows"] == (B if s["parent"] == starts["id"] else 3 * B)
        else:
            assert "adam_steps" not in s["attrs"]


@pytest.mark.parametrize("arch", ["starcoder2_3b", "rwkv6_1_6b"])
def test_prefill_gives_one_mixer_and_one_ffn_a_layer(store, arch):
    torch.set_num_threads(1)
    cfg, params, batch = _model(arch)
    plain = M.prefill(params, cfg, batch)
    with torch.profiler.profile(activities=CPU):
        traced = M.prefill(params, cfg, batch)
    assert torch.equal(plain, traced)

    snap = spans.snapshot()
    (root,) = [s for s in snap["spans"] if s["parent"] is None]
    assert root["name"] == "prefill" and root["attrs"]["tokens"] == 24
    kids = _children(snap, root["id"])
    assert [s["name"] for s in kids] == ["embed"] + ["mixer", "ffn"] * cfg.n_layers + ["head"]
    layers = kids[1:-1]
    assert [s["attrs"]["layer"] for s in layers] == [i for i in range(cfg.n_layers) for _ in (0, 1)]
    assert [s["attrs"]["kind"] for s in layers[::2]] == M.layer_kinds(cfg)
    assert snap["counters"] == {}
    assert len(snap["spans"]) == 1 + len(kids)

    # the device intervals tile the request: each child but the first opens
    # on the event its previous sibling closed on
    assert root["device"][0] <= kids[0]["device"][0]
    for a, b in zip(kids, kids[1:]):
        assert a["device"][1] == b["device"][0]
    assert kids[-1]["device"][1] <= root["device"][1]
    # one event a boundary: the root's two, the first child's entry, then
    # one exit a child
    assert store.clock.made == 3 + len(kids)


def test_device_intervals_follow_the_host_and_mesh_requests_keep_host_times(store):
    torch.set_num_threads(1)
    with torch.profiler.profile(activities=CPU):
        _solve()
        one = torch.tensor(1.0)
        res = solve_batch(sample_params_batch(5, 4, device="cpu"), Weights(one, one, one),
                          AllocatorConfig(inner="pgd", outer_iters=1, pgd=PGDConfig(steps=2)),
                          mesh=("cpu", "cpu"))
    assert res.alloc.X.shape[0] == 4
    snap = spans.snapshot()
    roots = [s for s in snap["spans"] if s["parent"] is None]
    assert [r["name"] for r in roots] == ["solve_batch", "score", "solve_batch"]
    for s in snap["spans"]:
        if s["root"] == roots[2]["id"]:
            assert s["device"] is None                               # the mesh's request
        else:
            lo, hi = s["device"]
            assert lo <= hi and s["host"][0] >= lo and s["host"][1] <= hi
    # the mesh's two chunks each ran Alg. A2 under the one request
    names = [s["name"] for s in _children(snap, roots[2]["id"])]
    assert names.count("starts") == 2 and names.count("select") == 2


def test_the_store_counts_the_spans_it_drops(monkeypatch):
    st = spans.Store(cap=5, clock=FakeClock())
    monkeypatch.setattr(spans, "STORE", st)
    cfg, params, batch = _model("starcoder2_3b")
    with torch.profiler.profile(activities=CPU):
        M.prefill(params, cfg, batch)
    snap = spans.snapshot()
    total = 3 + 2 * cfg.n_layers                 # prefill, embed, mixer and ffn a layer, head
    assert len(snap["spans"]) == 5 and snap["dropped"] == total - 5
    assert [s["name"] for s in snap["spans"]] == ["prefill", "embed", "mixer", "ffn", "mixer"]
    spans.clear()
    assert spans.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_the_launch_counters_are_read_over_each_span(store, monkeypatch):
    from repro_torch.kernels.flash_attention import kernel as flash_kernel

    with torch.profiler.profile(activities=CPU):
        with spans.root("request", "cpu"):
            with spans.span("outer"):
                monkeypatch.setattr(flash_kernel, "launches", flash_kernel.launches + 2)
                with spans.span("inner"):
                    monkeypatch.setattr(flash_kernel, "launches", flash_kernel.launches + 1)
    got = {s["name"]: s["attrs"]["flash_launches"] for s in spans.snapshot()["spans"]}
    assert got == {"request": 3, "outer": 3, "inner": 1}
