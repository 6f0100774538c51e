"""The yardstick's counts against brute-force counts on small shapes."""
from __future__ import annotations

import itertools
import math

import pytest
import torch

from fedbench import harness
from fedbench.yardstick import counting, peaks
from fedbench.tests.conftest import REPO


def brute_pairs(S, causal, window):
    """Every (query, key) pair the attention keeps, one at a time."""
    return sum(1 for q, k in itertools.product(range(S), range(S))
               if (not causal or k <= q) and (window is None or q - k < window))


@pytest.mark.parametrize("S", [1, 2, 7, 64, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 5, 64, 4096])
def test_attention_pairs_match_brute_force(S, causal, window):
    assert counting.attention_pairs(S, causal, window) == brute_pairs(S, causal, window)


def test_flash_bound_picks_the_larger_of_bytes_and_operations():
    # StarCoder2's layer at S 8192 in bf16: operations bound it
    secs, which = counting.flash_bound(1, 8192, 24, 2, 128, True, None)
    ops = 4 * 128 * 24 * counting.attention_pairs(8192, True, None)
    assert which == "operations" and secs == pytest.approx(ops / peaks.BF16_FLOPS_PER_S)
    # a short causal call moves more bytes than it computes
    secs, which = counting.flash_bound(4, 16, 8, 8, 64, True, None)
    assert which == "bytes"
    assert secs == pytest.approx(2 * (2 * 4 * 16 * 8 * 64 * 2) / peaks.HBM_BYTES_PER_S)


class CountingFloat(float):
    """A float that counts the arithmetic done on it."""

    ops = 0

    def _count(self, other, fn):
        CountingFloat.ops += 1
        return CountingFloat(fn(float(self), float(other)))

    __add__ = __radd__ = lambda s, o: s._count(o, lambda a, b: a + b)
    __mul__ = __rmul__ = lambda s, o: s._count(o, lambda a, b: a * b)


def wkv_by_hand(B, H, S, hd):
    """WKV6 as the function needs it (the bonus term factored out), every
    operation counted."""
    CountingFloat.ops = 0
    one = CountingFloat(0.5)
    for _b, _h in itertools.product(range(B), range(H)):
        state = [[CountingFloat(0.0)] * hd for _ in range(hd)]
        for _t in range(S):
            r = k = v = w = u = [one] * hd
            y = [CountingFloat(0.0)] * hd
            for i, j in itertools.product(range(hd), range(hd)):
                y[j] = y[j] + r[i] * state[i][j]                  # FMA: 2
                kv = k[i] * v[j]                                  # 1
                state[i][j] = w[i] * state[i][j] + kv             # FMA: 2
            bonus = CountingFloat(0.0)
            for i in range(hd):
                bonus = bonus + r[i] * u[i] * k[i]                # 3
            for j in range(hd):
                y[j] = y[j] + v[j] * bonus                        # 2
    return CountingFloat.ops


@pytest.mark.parametrize("shape", [(1, 1, 3, 4), (2, 3, 2, 5)])
def test_wkv_ops_match_an_operation_count(shape):
    assert counting.wkv_ops(*shape) == wkv_by_hand(*shape)


def _tiny(config):
    import json

    conf = json.loads((REPO / "fedbench" / "configs" / f"{config}.json").read_text())
    sizes = {"starcoder2-3b": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48, vocab=40),
             "rwkv6-1.6b": dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=96, vocab=40)}
    model = dict(conf["model"], dtype="float32", **sizes[config])
    mod = harness.load_module(REPO / "fedbench" / "configs" / f"{config}.py", f"ref_{config}".replace("-", "_").replace(".", "_"))
    return model, mod


@pytest.mark.parametrize("config", ["starcoder2-3b", "rwkv6-1.6b"])
def test_prefill_products_match_the_reference_products(config, monkeypatch):
    """2 x the matmul parameters x tokens equals the multiply-adds of every
    product the reference computes (its `linear` calls, counted)."""
    import fedbench.yardstick.plain as plain

    model, mod = _tiny(config)
    spec = mod.tree_spec(model)
    tree = harness.make_tree(spec, torch.Generator().manual_seed(0), torch.float32, "cpu")
    S = 9
    seen = []
    real = plain.linear

    def counted(x, w, fp8=False):
        seen.append(2 * math.prod(x.shape[:-1]) * w.shape[0] * w.shape[1])
        return real(x, w, fp8)

    monkeypatch.setattr(mod, "linear", counted)
    mod.logits(model, tree, torch.arange(S) % model["vocab"], list(range(S)))
    matmul = harness.spec_numel(spec, matmul_only=True)
    assert sum(seen) == 2 * matmul * S
    extra = counting.prefill_flops(model, matmul, S) - 2 * matmul * S
    if config == "starcoder2-3b":
        hd = model["d_model"] // model["n_heads"]
        assert extra == 4 * hd * model["n_heads"] * model["n_layers"] * S * (S + 1) // 2
    else:
        assert extra == model["n_layers"] * counting.wkv_ops(1, 2, S, 64)


def test_starcoder2_upload_is_its_parameter_tree_at_32_bits():
    import json

    conf = json.loads((REPO / "fedbench" / "configs" / "starcoder2-3b.json").read_text())
    mod = harness.load_module(REPO / "fedbench" / "configs" / "starcoder2-3b.py", "ref_sc2_bits")
    n = harness.spec_numel(mod.tree_spec(conf["model"]))
    assert 3.18e9 < n < 3.19e9
    assert 32 * n == pytest.approx(1.018e11, rel=1e-3)


@pytest.mark.parametrize("S, window", [(40, None), (40, 7), (40, 64), (13, 1)])
def test_the_dense_reference_keeps_the_pairs_it_is_counted_for(monkeypatch, S, window):
    # q = k = 0 spreads each query evenly over the keys it keeps; v = the
    # identity then returns those weights, whose nonzeros are the pairs
    ref = harness.load_module(REPO / "fedbench" / "configs" / "starcoder2-3b.py", "fedbench_ref_pairs")
    monkeypatch.setattr(ref, "Q_BLOCK", 8)
    zeros = torch.zeros(S, 1, S)
    out = ref._attention(zeros, zeros, torch.eye(S)[:, None, :], True, window)
    assert int(torch.count_nonzero(out)) == counting.attention_pairs(S, True, window)
