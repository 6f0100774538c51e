"""The device trace's reduction: busy time as the union of kernel intervals,
idle gaps filed under the host span that holds them, and the readers on a
summary built by hand."""
from __future__ import annotations

import pytest

from fedbench.yardstick import trace as tr


def test_busy_is_the_union_and_gaps_go_to_their_spans():
    events = [("a", 10, 20), ("b", 15, 30), ("a", 40, 50), ("c", 95, 120), ("early", 0, 5)]
    spans = [(0, 35, "request 1"), (35, 100, "request 2")]
    s = tr.summarize(events, (8, 100), spans)
    assert s["kernels"] == {"a": [2, 20e-9], "b": [1, 15e-9], "c": [1, 25e-9]}
    assert s["busy_s"] == pytest.approx((30 - 10 + 50 - 40 + 100 - 95) * 1e-9)  # clipped at 100
    assert s["window_s"] == pytest.approx(92e-9)
    # gaps: 8-10 (request 1), 30-40 (midpoint 35: request 2), 50-95 (request 2)
    assert s["idle"]["request 1"] == pytest.approx(2e-9)
    assert s["idle"]["request 2"] == pytest.approx(55e-9)
    b = tr.breakdown(s)
    assert b["device_ops"][0][0] == "c" and b["idle_gaps"][0] == ["request 2", s["idle"]["request 2"]]


def test_an_idle_window_is_all_gap():
    s = tr.summarize([], (0, 1000), [])
    assert s["busy_s"] == 0 and s["idle"] == {"between the harness's spans": 1e-6}


class Rec:
    kind = "prefill"
    model = {"n_layers": 2, "d_model": 256, "n_heads": 2, "n_kv_heads": 1, "block_pattern": ["attn"],
             "dtype": "bfloat16", "causal": True}
    matmul_params = 1000
    lengths = [128, 256]
    window_s = 1.0


def _load(name):
    from fedbench import harness
    from fedbench.tests.conftest import REPO

    return harness.load_module(REPO / "fedbench" / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


def test_readers_on_a_summary():
    from fedbench.yardstick import counting

    rec = Rec()
    rec.trace = {"kernels": {"sm90::flash_fwd_kernel_sm90<128, 128>": [4, 2e-3], "nvjet_tst_x": [9, 3e-3],
                             "elementwise_add": [20, 1e-3]},
                 "busy_s": 0.6, "window_s": 1.0, "idle": {}}
    bound = 2 * sum(counting.flash_bound(1, L, 2, 1, 128, True, None)[0] for L in (128, 256))
    assert _load("flash_roofline").read(rec) == pytest.approx(100 * bound / 2e-3)
    assert _load("prefill_matmul_us_per_tok").read(rec) == pytest.approx(1e6 * 3e-3 / 384)
    assert _load("prefill_other_us_per_tok").read(rec) == pytest.approx(1e6 * 1e-3 / 384)
    assert _load("device_idle_pct.prefill").read(rec) == pytest.approx(40.0)
    assert _load("device_idle_pct.alloc").read(rec) is None
    assert _load("wkv6_roofline").read(rec) is None            # no WKV6 launch in the trace
    rec.trace["kernels"]["sm90::flash_fwd_kernel_sm90<128, 128>"] = [3, 2e-3]
    assert _load("flash_roofline").read(rec) is None           # a launch missing: nothing to read
