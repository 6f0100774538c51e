"""The program's own spans (`repro_torch.spans`), as the per-layer readers
read them: the spans of the window's requests, and None where the program
has no spans, holds host times only, or its requests are not the window's.

A run's requests are the roots named after its kind (`solve_batch` for an
allocation, `prefill` for a prefill), one a solve or a prompt of the window.
"""
from __future__ import annotations

ROOTS = {"fl_alloc": "solve_batch", "prefill": "prefill"}


def _requests(rec):
    """(the window's root spans, every span under them), or None."""
    if rec.kind not in ROOTS:
        return None
    want = rec.solves if rec.kind == "fl_alloc" else len(rec.lengths or ())
    if not want:
        return None
    try:
        from repro_torch import spans
    except ImportError:             # a program without spans
        return None
    snap = spans.snapshot()["spans"]
    roots = [s for s in snap if s["parent"] is None and s["name"] == ROOTS[rec.kind]]
    if len(roots) != want:
        return None
    ids = {s["id"] for s in roots}
    return roots, [s for s in snap if s["root"] in ids]


def device_ns(rec, name: str):
    """Device ns of every span ``name`` of the window's requests, summed."""
    found = _requests(rec)
    if found is None:
        return None
    timed = [s["device"] for s in found[1] if s["name"] == name]
    if not timed or None in timed:
        return None
    return sum(b - a for a, b in timed)


def per_solve_s(rec, name: str):
    """Device seconds of the spans ``name`` per `solve_batch`."""
    ns = device_ns(rec, name) if rec.kind == "fl_alloc" else None
    return None if ns is None else ns / 1e9 / rec.solves


def per_token_us(rec, name: str):
    """Device us of the spans ``name`` per prompt token."""
    ns = device_ns(rec, name) if rec.kind == "prefill" else None
    return None if ns is None else ns / 1e3 / sum(rec.lengths)


def dispatch_ms(rec):
    """Mean host ms of the `prefill` roots of the traffic's shortest prompt,
    entry to return (before the caller's synchronize); the requests must
    carry device intervals, as a traced run's do."""
    found = _requests(rec) if rec.kind == "prefill" else None
    if found is None or any(s["device"] is None for s in found[0]):
        return None
    short = min(rec.lengths)
    host = [s["host"][1] - s["host"][0] for s in found[0] if s["attrs"].get("tokens") == short]
    return sum(host) / len(host) / 1e6 if host else None
