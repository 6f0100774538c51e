"""The comparison that decides a prefill's ``correct``: the program's logits
at the compared positions against the plain reference's, in float32.

* ``logit_gap``: the widest gap, over every compared position, by which the
  reference's logit of the token the program puts first lies below the
  reference's best (0 where they pick the same token): what a greedy
  decoder served from these logits would lose.
* ``logit_rel_err``: ||program - reference|| / ||reference|| over all the
  compared logits.
"""
from __future__ import annotations

import torch


def readings(pairs) -> dict:
    """``pairs``: (program logits, reference logits) per compared request,
    each (positions, V)."""
    gap, num, den, bad = 0.0, 0.0, 0.0, 0
    for prog, ref in pairs:
        prog, ref = prog.float(), ref.float()
        finite = torch.isfinite(prog).all(dim=-1)
        bad += int((~finite).sum())
        top = torch.argmax(prog, dim=-1)
        g = ref.max(dim=-1).values - ref.gather(-1, top[:, None])[:, 0]
        gap = max(gap, float(g.max()))
        num += float(torch.sum(torch.square(prog - ref)))
        den += float(torch.sum(torch.square(ref)))
    rel = (num / den) ** 0.5 if den > 0 else float("inf")
    if bad:
        gap, rel = float("inf"), float("inf")
    return {"logit_gap": gap, "logit_rel_err": rel, "non_finite_positions": bad}


def compared_positions(L: int, n: int) -> list[int]:
    """``n`` positions of an L-token prompt, evenly spaced and ending at the
    last (whose first token a greedy decoder serves)."""
    n = min(n, L)
    step = L // n
    return sorted(L - 1 - j * step for j in range(n))
