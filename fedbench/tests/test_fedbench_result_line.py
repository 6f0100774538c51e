"""The result line and the run's refusals."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from fedbench import harness
from fedbench.tests.conftest import REPO, make_root, run_tiny


def test_the_line_has_the_contract_keys_with_compared_last():
    compared = {"logit_gap": {"value": 0.1, "limit": 0.5}}
    line = json.loads(harness.result_line(True, 10, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                                          {"platform": "gpu", "kind": "x", "count": 1,
                                           "memory_peak_bytes": 1}, compared,
                                          {"device_ops": [], "idle_gaps": []}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "compared"]
    assert harness.compared_lines(compared) == ["compared logit_gap: 0.1 limit 0.5"]


def test_a_tiny_run_reports_the_cells_metrics(tmp_path):
    root = make_root(tmp_path)
    out = run_tiny(root, "tiny-dense.prefill")
    assert out["correct"] and out["attempted"] == 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "prefill_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["compared"]) == set(harness.find_cell(root, "tiny-dense.prefill").limits)
    out = run_tiny(root, "fl-job.fl-alloc")
    assert set(out["metrics"]) == {"alloc_scenarios_per_s", "setup_s"}
    assert out["attempted"] == harness.find_cell(root, "fl-job.fl-alloc").traffic["batch"]


def test_no_card_no_result():
    """Without a CUDA card the run exits 2 and prints no line (the CPU
    sandbox has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure it")
    proc = subprocess.run([sys.executable, "-m", "fedbench.run", "--workload", "starcoder2-3b.prefill-code",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_without_the_program_the_run_fails_and_prints_nothing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run cannot import the program (on a card) or finds no card (here)."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "fedbench", tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run([sys.executable, "-m", "fedbench.run", "--workload", "rwkv6-1.6b.prefill-long",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
