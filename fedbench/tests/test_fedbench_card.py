"""Every cell on the card, as the driver runs it, briefly: `correct` and the
metrics the cell reports. Run on the card with
``python3 -m pytest -m cuda fedbench/tests``; skips without one."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from fedbench.tests.conftest import REPO


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    proc = subprocess.run([sys.executable, "-m", "fedbench.run", "--workload", workload, "--seed",
                           "2147483659", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
