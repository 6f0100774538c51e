"""A checkout in miniature for the CPU tests: the benchmark's own code, and
data files of tiny cells (the real configurations' references and the real
cells' limits, at sizes a CPU test holds)."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tiny configurations: name -> (the real configuration, the sizes changed):
#: narrow, at the real depth (rounding grows with it, and the control has to
#: fail the real limits); the allocation cell draws no weights and keeps the
#: real model, whose parameter count sets the FL upload; the dense model's
#: window is cut so that the prompts of its tiny cell pass it
TINY_MODELS = {
    "tiny-dense": ("starcoder2-3b", dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
                                         sliding_window=64)),
    "tiny-rwkv": ("rwkv6-1.6b", dict(d_model=128, n_heads=2, n_kv_heads=2, d_ff=256, vocab=512)),
    "fl-job": ("starcoder2-3b", {}),
}
#: tiny cells: name -> (tiny configuration, real traffic, its changes, real cell)
TINY_CELLS = {
    "tiny-dense.prefill": ("tiny-dense", "prefill-code",
                           dict(lengths=[48, 96], token_pool=8192, compare={"positions": 16}),
                           "starcoder2-3b.prefill-code"),
    "tiny-rwkv.prefill": ("tiny-rwkv", "prefill-long",
                          dict(lengths=[48, 96], token_pool=8192, compare={"positions": 16}),
                          "rwkv6-1.6b.prefill-long"),
    "fl-job.fl-alloc": ("fl-job", "fl-alloc", dict(batch=8, batches=1), "starcoder2-3b.fl-alloc"),
}


def _write(path: pathlib.Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: pathlib.Path, model_dtype: str = "bfloat16") -> pathlib.Path:
    """A directory laid out like a checkout, holding the tiny cells."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    fb = tmp / "fedbench"
    configs = []
    for name, (src, sizes) in TINY_MODELS.items():
        conf = json.loads((REPO / "fedbench" / "configs" / f"{src}.json").read_text())
        conf["name"] = name
        if sizes:
            conf["model"] = dict(conf["model"], name=name, dtype=model_dtype, **sizes)
        _write(fb / "configs" / f"{name}.json", conf)
        shutil.copy(REPO / "fedbench" / "configs" / f"{src}.py", fb / "configs" / f"{name}.py")
        configs.append({"name": name, "source": "https://example.org/tiny", "reduced": [],
                        "file": f"fedbench/configs/{name}.json", "why": "CPU test"})
    workloads = []
    for cell, (conf, traffic, changes, real_cell) in TINY_CELLS.items():
        t = json.loads((REPO / "fedbench" / "traffic" / f"{traffic}.json").read_text())
        t.update(changes)
        _write(fb / "traffic" / f"tiny-{traffic}.json", t)
        _write(fb / "limits" / f"{cell}.json",
               json.loads((REPO / "fedbench" / "limits" / f"{real_cell}.json").read_text()))
        workloads.append({"name": cell, "config": conf, "traffic": f"tiny-{traffic}", "chips": 1,
                          "why": "CPU test"})
    shutil.copytree(REPO / "fedbench" / "metrics", fb / "metrics")
    bench = dict(real, configs=configs, workloads=workloads)
    tiny_of = {real_cell: cell for cell, (*_, real_cell) in TINY_CELLS.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_of[w] for w in m["workloads"] if w in tiny_of]
    _write(tmp / "BENCHMARK.json", bench)
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def run_tiny(root: pathlib.Path, workload: str, seed: int = 7, seconds: float = 0.0) -> dict:
    """A run of a tiny cell on the CPU: everything but the look for a card."""
    import torch

    from fedbench import harness
    from fedbench.run import run_cell

    torch.set_num_threads(1)
    cell = harness.find_cell(root, workload)
    return run_cell(cell, seed, seconds, False, torch.device("cpu"))
