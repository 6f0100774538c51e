"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have (`fedbench.faults`, the same definitions that
`fedbench.calibrate` reads on the card), planted in the program, on the
tiny cells (the real cells' limits, on the CPU, past the harness's look for
a card).

The prefill cells serve one prompt at a time, so they cannot leave half of
a batch out, and no cell spans chips; the allocation cell's batch can."""
from __future__ import annotations

import pytest

from fedbench import faults
from fedbench.tests.conftest import run_tiny


def test_sound_runs_are_correct(tiny_root):
    for cell in ("tiny-dense.prefill", "tiny-rwkv.prefill", "fl-job.fl-alloc"):
        assert run_tiny(tiny_root, cell)["correct"], cell


@pytest.mark.parametrize("cell, fault", [
    ("tiny-dense.prefill", faults.mixer_unchanged),
    ("tiny-rwkv.prefill", faults.time_mix_unchanged),
    ("tiny-dense.prefill", faults.served_token_altered),
    ("tiny-rwkv.prefill", faults.served_token_altered),
])
def test_prefill_faults_are_caught(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch.setattr)
    assert not run_tiny(tiny_root, cell)["correct"]


@pytest.mark.parametrize("fault", [
    faults.steps_unchanged,
    faults.on_answer(faults.half_batch),
    faults.on_answer(faults.answer_altered),
    faults.steps_reversed,
    faults.power_gradient_lost,
], ids=lambda f: f.__name__)
def test_allocation_faults_are_caught(tiny_root, monkeypatch, fault):
    fault(monkeypatch.setattr)
    assert not run_tiny(tiny_root, "fl-job.fl-alloc")["correct"]


def test_a_planted_fault_is_undone():
    import repro_torch.core.pgd as pgd

    real = pgd._adam_update
    with faults.planted(faults.steps_unchanged):
        assert pgd._adam_update is not real
    assert pgd._adam_update is real
