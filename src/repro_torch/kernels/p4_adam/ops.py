"""Alg. A2's Adam loops on the card: the kernel's layout.

The loops of `core.pgd.solve_p4_pgd` (``pgd_loop``) and
`core.pgd.power_given_x` (``power_loop``) from given logits, as one launch
of the CUDA kernel. The JAX reference runs them as an XLA-fused scan and
has no kernel for them. `core.pgd` chooses the route: CUDA tensors come
here, CPU tensors take its eager autograd loops (`_pgd_loop`,
`_power_loop`), which are also the kernel's plain version and may be called
on CUDA tensors to hold the kernel against. Anything else than CUDA
tensors, or a shape the kernel does not take (`kernel.MAX_N`,
`kernel.MAX_K`), raises; nothing falls back.

Both return (P, X, logits, moments) in the order of `core.pgd.AdamRun`:
the decode after the last step, the logits and their Adam moments (None
unless ``moments`` is set). The scenario rows, the weights and the logits
are broadcast to one leading shape, flattened to rows for the launch, and
the outputs get that shape back. This module imports nothing of `core`.
"""
from __future__ import annotations

import torch

from . import kernel


def _layout(params, kappa1, payload, rmin, nk: dict, n: dict):
    """The rows' leading shape and every input as a contiguous float32
    (R, ...) tensor: the scenario rows, ``nk`` leaves (..., rows, K) and
    ``n`` leaves (..., N)."""
    dev = params.g.device
    kap = torch.as_tensor(kappa1, dtype=torch.float32, device=dev)
    row_leaves = dict(p_max=params.p_max, dev_mask=params.dev_mask, payload=payload, rmin=rmin, **n)
    lead = torch.broadcast_shapes(
        params.g.shape[:-2], params.sc_mask.shape[:-1], kap.shape,
        *(x.shape[:-1] for x in row_leaves.values()), *(x.shape[:-2] for x in nk.values()))
    R = 1
    for d in lead:
        R *= d

    def flat(x, tail):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return torch.broadcast_to(x, lead + tail).reshape((R,) + tail).contiguous()

    N, K = params.g.shape[-2:]
    out = dict(g=flat(params.g, (N, K)), sc_mask=flat(params.sc_mask, (K,)), kappa1=flat(kap, ()))
    out.update({k: flat(x, (N,)) for k, x in row_leaves.items()})
    out.update({k: flat(x, tuple(x.shape[-2:])) for k, x in nk.items()})
    return lead, out


def _shaped(lead, P, X, logits, moments):
    """The kernel's (R, ...) outputs with the rows' leading shape."""
    back = lambda x: x.reshape(lead + tuple(x.shape[1:]))
    return (back(P), back(X), tuple(map(back, logits)),
            None if moments is None else tuple(tuple(map(back, mv)) for mv in moments))


def pgd_loop(params, kappa1, payload, rmin, z, w, w_tot, cfg, *, moments: bool = False):
    """`solve_p4_pgd`'s ``cfg.steps`` Adam steps from the logits z (..., N+1,
    K), w (..., N, K) and w_tot (..., N), and the decode at ``cfg.temp_end``,
    in one kernel launch: (P, X, (z, w, w_tot), moments)."""
    lead, t = _layout(params, kappa1, payload, rmin, dict(z=z, w=w), dict(w_tot=w_tot))
    P, X, logits, mom = kernel.pgd_loop(
        t["g"], t["p_max"], t["dev_mask"], t["sc_mask"], t["payload"], t["rmin"], t["kappa1"],
        t["z"], t["w"], t["w_tot"], steps=cfg.steps, q=params.q, lr=cfg.lr,
        penalty_rate=cfg.penalty_rate, penalty_binary=cfg.penalty_binary,
        temp_end=cfg.temp_end, bbar=params.bbar, noise_sc=params.noise_sc, moments=moments)
    return _shaped(lead, P, X, logits, mom)


def power_loop(params, kappa1, payload, rmin, X, w, w_tot, steps: int, lr: float,
               penalty_rate: float, *, moments: bool = False):
    """`power_given_x`'s ``steps`` Adam steps for the fixed X (..., N, K) from
    the logits w (..., N, K) and w_tot (..., N), and the decode, in one
    kernel launch: (P, X as given, (w, w_tot), moments)."""
    lead, t = _layout(params, kappa1, payload, rmin, dict(X=X, w=w), dict(w_tot=w_tot))
    P, logits, mom = kernel.power_loop(
        t["g"], t["p_max"], t["dev_mask"], t["sc_mask"], t["payload"], t["rmin"], t["kappa1"],
        t["X"], t["w"], t["w_tot"], steps=steps, lr=lr, penalty_rate=penalty_rate,
        bbar=params.bbar, noise_sc=params.noise_sc, moments=moments)
    return _shaped(lead, P, t["X"], logits, mom)
