"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names, and the harness opens nothing under benchmarks/."""
from __future__ import annotations

import json
import subprocess
import sys

from fedbench import harness
from fedbench.tests.conftest import REPO

PROBE = r'''
import json, pathlib, sys, tempfile
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args and isinstance(args[0], (str, bytes, pathlib.Path)) else None)
sys.path[:0] = [{repo!r}, {src!r}]
from fedbench.tests.conftest import make_root, run_tiny
root = make_root(pathlib.Path(tempfile.mkdtemp()))
outs = [run_tiny(root, cell)["correct"] for cell in ("tiny-dense.prefill", "tiny-rwkv.prefill", "fl-job.fl-alloc")]
print(json.dumps({{"tops": sorted({{m.split(".", 1)[0] for m in sys.modules}}), "opened": opened, "correct": outs}}))
'''


def test_a_run_loads_no_jax_and_reads_nothing_under_benchmarks():
    code = PROBE.format(repo=str(REPO), src=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "PYTHONNOUSERSITE": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] == [True, True, True]
    assert "repro_torch" in out["tops"] and "torch" in out["tops"]
    assert not set(out["tops"]) & {"jax", "jaxlib", "flax", "repro"}
    bench_dir = str(REPO / "benchmarks")
    assert not [p for p in out["opened"] if p.startswith(bench_dir) or "/benchmarks/" in p]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_loaded() == ["jax", "repro"]


def test_the_harness_sources_import_no_jax():
    for path in (REPO / "fedbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for bad in ("import jax", "from jax", "import repro\n", "from repro ", "from repro.", "import repro.",
                    "benchmarks/"):
            assert bad not in text, (path, bad)
