"""BENCHMARK.json keeps the shape the benchmark's contract gives it."""
from __future__ import annotations

import json
import re

import pytest

from fedbench.tests.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(LINE(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE(c["source"]) and LINE(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"])) and (REPO / c["file"]).exists()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE(w["why"])
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        keys = {"name", "unit", "better", "source"} | ({"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert LINE(m["layer"]) and m["moves"] in e2e
            moved = set(e2e[m["moves"]].get("workloads", cells))
            assert set(m.get("workloads", moved)) <= moved
    if kind == "end_to_end":
        assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
        for cell in cells:
            reports = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
            assert len(reports) >= 2
            assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_roofline_and_mfu_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert any("mfu" in re.split(r"[_.]", m["name"]) for m in BENCH["per_layer"])


def test_paths_hold_the_benchmark_only():
    for p in BENCH["paths"]:
        assert (REPO / p).is_dir() and not p.endswith("_torch")
