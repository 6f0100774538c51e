"""The harness finds a cell's configuration, traffic mix, limits and metric
readers by the names in BENCHMARK.json, so later work adds files only."""
from __future__ import annotations

import json

import pytest

from fedbench import harness
from fedbench.tests.conftest import REPO, make_root


def test_every_cell_of_the_benchmark_resolves():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.find_cell(REPO, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.reference_path.exists()
        assert cell.traffic["kind"] in ("prefill", "fl_alloc")
        assert (REPO / "fedbench" / "drivers" / f"{cell.traffic['kind']}.py").exists()
        assert set(cell.limits) and all("limit" in v for v in cell.limits.values())
        for m in cell.per_layer:
            assert (REPO / "fedbench" / "metrics" / f"{m['name']}.py").exists()
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_a_new_cell_mix_and_metric_are_found_from_files_alone(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # a new traffic mix and a new cell: data files and entries only
    mix = json.loads((root / "fedbench" / "traffic" / "tiny-prefill-code.json").read_text())
    mix["lengths"] = [32]
    (root / "fedbench" / "traffic" / "tiny-short.json").write_text(json.dumps(mix))
    (root / "fedbench" / "limits" / "tiny-dense.short.json").write_text(
        (root / "fedbench" / "limits" / "tiny-dense.prefill.json").read_text())
    bench["workloads"].append({"name": "tiny-dense.short", "config": "tiny-dense",
                               "traffic": "tiny-short", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"].append("tiny-dense.short")
    # a new per-layer metric: its reader file and an entry naming its cells
    (root / "fedbench" / "metrics" / "requests_done.py").write_text(
        "def read(rec):\n    return float(len(rec.lengths)) if rec.kind == 'prefill' else None\n")
    bench["per_layer"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "prefill_tokens_per_s",
                               "workloads": ["tiny-dense.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(root, "tiny-dense.short")
    assert cell.traffic["lengths"] == [32]
    assert "requests_done" in [m["name"] for m in cell.per_layer]
    alloc = harness.find_cell(root, "fl-job.fl-alloc")
    assert "requests_done" not in [m["name"] for m in alloc.per_layer]

    class Rec:
        kind, lengths = "prefill", [32, 32, 32]
    assert harness.read_metrics(cell, Rec())["requests_done"] == {"value": 3.0, "unit": "requests"}


def test_a_per_layer_metric_without_its_cells_is_refused(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"][0].pop("workloads")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="lists no workloads"):
        harness.find_cell(root, "fl-job.fl-alloc")


def test_an_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.find_cell(REPO, "no-such-cell")


def test_seeds_are_distinct_per_purpose_and_take_large_numbers():
    a = harness.sub_seed(2**31 + 12345, "weights")
    assert a == harness.sub_seed(2**31 + 12345, "weights")
    assert a != harness.sub_seed(2**31 + 12345, "tokens") != harness.sub_seed(2**31 + 12346, "tokens")
    assert 0 <= a < 2**63
