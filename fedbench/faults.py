"""Faults planted underneath a run, each defined once: the CPU tests
(`tests/test_fedbench_faults.py`) plant them through pytest's monkeypatch,
`fedbench.calibrate` reads them on the card at the cells' own sizes.

A fault is a function of ``setattr(obj, name, value)`` that breaks the timed
path where its output is produced; `planted` plants one for the length of a
``with`` block. The allocation faults that only rewrite the solver's answer
are also given as transforms of a result (`half_batch`, `answer_altered`),
so a reading can apply them to an answer already made. A run never imports
this module.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def planted(fault):
    """``fault`` planted in the program inside the block, undone after it."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        fault(patch)
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def mixer_unchanged(patch):
    """Every attention layer returns the residual stream unchanged."""
    import repro_torch.models.model as M

    patch(M, "_mixer", lambda blk, cfg, x, *a, **k: x)


def time_mix_unchanged(patch):
    """Every RWKV time mix returns nothing to add: its layer leaves the
    residual stream as it found it."""
    import repro_torch.models.rwkv as R

    patch(R, "time_mix", lambda p, cfg, x, *a, **k: (torch.zeros_like(x), None))


def served_token_altered(patch):
    """The token a greedy decoder would serve (the last position's first)
    is replaced where the logits are produced."""
    import repro_torch.models.model as M

    real = M.prefill

    def altered(*a, **k):
        out = real(*a, **k)
        last = out[:, -1]
        last[:, (torch.argmax(last, dim=-1) + 1) % last.shape[-1]] += 100.0
        return out

    patch(M, "prefill", altered)


# ---------------------------------------------------------------------------
# allocation
# ---------------------------------------------------------------------------

def steps_unchanged(patch):
    """Every Adam step of the solver (PGD and the power re-solve) returns
    its state unchanged."""
    import repro_torch.core.pgd as pgd

    patch(pgd, "_adam_update", lambda g, m, v, t, lr, *a: (torch.zeros_like(g), m, v))


def steps_reversed(patch):
    """Every Adam step of the solver climbs its loss instead of descending."""
    import repro_torch.core.pgd as pgd

    real = pgd._adam_update

    def reversed_step(*a, **k):
        d, m, v = real(*a, **k)
        return -d, m, v

    patch(pgd, "_adam_update", reversed_step)


def power_gradient_lost(patch):
    """Every gradient the solver takes with respect to its power logits
    (PGD's and the power re-solve's ``w``, the next to last argument of
    `pgd._grad` in both) comes back zero."""
    import repro_torch.core.pgd as pgd

    real = pgd._grad

    def lost(loss_fn, *xs):
        grads = list(real(loss_fn, *xs))
        grads[-2] = torch.zeros_like(grads[-2])
        return tuple(grads)

    patch(pgd, "_grad", lost)


def half_batch(res, B: int):
    """Half of the batch left out: its scenarios get the answers the solver
    made for the other half (rows are independent, so the first half's
    answers are those of a solve of that half alone)."""
    from repro_torch.core.types import tree_map

    return tree_map(lambda x: torch.cat([x[: B - B // 2], x[: B // 2]]), res)


def answer_altered(res, B: int):
    """One scenario's first subcarrier handed to another device where the
    allocation is produced."""
    X = res.alloc.X[0]
    owner = int(torch.argmax(X[:, 0]))
    X[owner, 0], X[(owner + 1) % X.shape[0], 0] = 0.0, 1.0
    return res


def on_answer(transform):
    """The fault that applies ``transform`` to every answer of `solve_batch`."""
    def fault(patch):
        import repro_torch.core as core

        real = core.solve_batch

        def wrapped(params, *a, **k):
            return transform(real(params, *a, **k), params.g.shape[0])

        patch(core, "solve_batch", wrapped)

    fault.__name__ = transform.__name__
    return fault
