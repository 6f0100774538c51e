"""The readers of the program's spans (`repro_torch.spans`) on snapshots
built by hand: the value each gives, and None where the store holds host
times only, where its requests do not match the window's, or where the
program has no spans at all."""
from __future__ import annotations

import sys

import pytest

from fedbench.tests.conftest import REPO

MS = 1_000_000      # ns


def _load(name):
    from fedbench import harness

    return harness.load_module(REPO / "fedbench" / "metrics" / f"{name}.py", "m_" + name)


def _span(i, name, parent, root, host, device, **attrs):
    return {"id": i, "parent": parent, "root": root, "name": name, "attrs": attrs,
            "host": host, "device": device}


def _solves(timed=True):
    """Two `solve_batch` requests and a `batch_objectives` one: device
    intervals in ms."""
    d = (lambda a, b: (a * MS, b * MS)) if timed else (lambda a, b: None)
    out = []
    for r, t in ((0, 0), (10, 1000)):
        out += [_span(r, "solve_batch", None, r, (t, t + 900), d(t, t + 900)),
                _span(r + 1, "starts", r, r, (t, t + 60), d(t, t + 60)),
                _span(r + 2, "pgd", r + 1, r, (t + 5, t + 55), d(t + 5, t + 55)),
                _span(r + 3, "p3", r, r, (t + 60, t + 70), d(t + 60, t + 70)),
                _span(r + 4, "pgd", r, r, (t + 70, t + 470), d(t + 70, t + 470)),
                _span(r + 5, "power_given_x", r, r, (t + 500, t + 800), d(t + 500, t + 800)),
                _span(r + 6, "select", r, r, (t + 800, t + 900), d(t + 800, t + 900))]
    out.append(_span(20, "score", None, 20, (2000, 2001), d(2000, 2001)))
    # a `pgd` span outside any request of the window: not read
    out.append(_span(21, "pgd", 20, 20, (2000, 2001), d(2000, 2001)))
    return out


def _prefills(timed=True):
    """Three `prefill` requests of 100, 200 and 100 tokens, two layers each."""
    d = (lambda a, b: (a * MS, b * MS)) if timed else (lambda a, b: None)
    out, i = [], 0
    for t, L, host_ms in ((0, 100, 7), (100, 200, 9), (300, 100, 5)):
        r = i
        out.append(_span(r, "prefill", None, r, (t * MS, (t + host_ms) * MS), d(t, t + 50), tokens=L))
        out.append(_span(r + 1, "embed", r, r, (t, t), d(t, t + 1)))
        for layer in range(2):
            base = t + 1 + 20 * layer
            out.append(_span(r + 2 + 2 * layer, "mixer", r, r, (0, 0), d(base, base + 12), layer=layer))
            out.append(_span(r + 3 + 2 * layer, "ffn", r, r, (0, 0), d(base + 12, base + 20), layer=layer))
        out.append(_span(r + 6, "head", r, r, (0, 0), d(t + 41, t + 50)))
        i += 7
    return out


class AllocRec:
    kind = "fl_alloc"
    solves = 2


class PrefillRec:
    kind = "prefill"
    lengths = [100, 200, 100]


@pytest.fixture
def store(monkeypatch):
    """Point the program's `spans.snapshot` at a hand-built list of spans."""
    from repro_torch import spans

    held = {}
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": held["spans"], "counters": {}, "dropped": 0})

    def put(snap):
        held["spans"] = snap
    return put


def test_alloc_readers(store):
    store(_solves())
    # pgd: (50 + 400) ms a solve; power_given_x: 300 ms a solve
    assert _load("alloc_pgd_s_per_solve").read(AllocRec()) == pytest.approx(0.45)
    assert _load("alloc_power_s_per_solve").read(AllocRec()) == pytest.approx(0.3)
    assert _load("prefill_mixer_us_per_tok").read(AllocRec()) is None


def test_prefill_readers(store):
    store(_prefills())
    # mixer: 2 x 12 ms a request, 3 requests, over 400 tokens
    assert _load("prefill_mixer_us_per_tok").read(PrefillRec()) == pytest.approx(3 * 24e3 / 400)
    assert _load("prefill_ffn_us_per_tok").read(PrefillRec()) == pytest.approx(3 * 16e3 / 400)
    # the host's time of the two 100-token requests: 7 and 5 ms
    assert _load("prefill_dispatch_ms_per_req").read(PrefillRec()) == pytest.approx(6.0)
    assert _load("alloc_pgd_s_per_solve").read(PrefillRec()) is None


@pytest.mark.parametrize("name", ["alloc_pgd_s_per_solve", "alloc_power_s_per_solve",
                                  "prefill_mixer_us_per_tok", "prefill_ffn_us_per_tok",
                                  "prefill_dispatch_ms_per_req"])
def test_readers_give_none_without_device_intervals_or_matching_requests(store, name):
    alloc = name.startswith("alloc")
    rec, make = (AllocRec(), _solves) if alloc else (PrefillRec(), _prefills)
    store(make(timed=False))
    assert _load(name).read(rec) is None
    store([])
    assert _load(name).read(rec) is None
    store(make())
    assert _load(name).read(rec) is not None
    if alloc:
        rec.solves = 3
    else:
        rec.lengths = [100, 200]
    assert _load(name).read(rec) is None


@pytest.mark.parametrize("name", ["alloc_pgd_s_per_solve", "prefill_dispatch_ms_per_req"])
def test_readers_give_none_on_a_program_without_spans(monkeypatch, name):
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)      # the import fails
    with pytest.raises(ImportError):
        from repro_torch import spans  # noqa: F401
    rec = AllocRec() if name.startswith("alloc") else PrefillRec()
    assert _load(name).read(rec) is None
