"""The control comes out not correct at a size a test holds: the plain
reference with every product in fp8 in a prefill's program's place, and an
allocation rounded to bfloat16 (the nearest precisions below the
configurations' bf16 and float32). On the card, at the cells' own sizes:
`python3 -m fedbench.calibrate` (PERF.md gives the readings)."""
from __future__ import annotations

import pytest
import torch

from fedbench import harness
from fedbench.yardstick import logits as cmp


@pytest.mark.parametrize("cell", ["tiny-dense.prefill", "tiny-rwkv.prefill"])
def test_fp8_control_fails_the_prefill_limits(tiny_root, cell):
    from fedbench.drivers.prefill import Setup

    c = harness.find_cell(tiny_root, cell)
    for seed in (1, 2, 3):
        st = Setup(c, seed, torch.device("cpu"))
        pairs = []
        for L in st.lengths:
            off = st.next_offset(L)
            pairs.append((st.reference(off, L, fp8=True), st.reference(off, L)))
        correct, compared = harness.judge(cmp.readings(pairs), c.limits)
        assert not correct, compared


def test_bf16_control_fails_the_allocation_limits(tiny_root):
    from fedbench.drivers.fl_alloc import Setup, leaves

    c = harness.find_cell(tiny_root, "fl-job.fl-alloc")
    st = Setup(c, 4, torch.device("cpu"))
    alloc, obj = st.solve(0)
    bf16 = lambda x: x.to(torch.bfloat16).to(x.dtype)
    rounded = {k: v if k == "X" else bf16(v) for k, v in leaves(alloc).items()}
    readings = st.judge(0, rounded, bf16(obj))
    correct, compared = harness.judge(readings, c.limits)
    assert not correct, compared
    assert harness.judge(st.judge(0, leaves(alloc), obj), c.limits)[0]
