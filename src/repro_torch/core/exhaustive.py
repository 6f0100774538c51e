"""Approximate exhaustive search (paper §V-F, Table II): the oracle.

Counterpart of `repro.core.exhaustive`, with the same enumeration, candidate
layout, chunking and results. All N^K subcarrier assignments are enumerated
exactly (`itertools.product`, the owner of subcarrier 0 slowest), and each
assignment sweeps a per-device (f, p, rho) grid; a device's power level is
spread equally over its subcarriers. Assignments ride the batched
`kernels.fedsem_objective` evaluator in chunks: each chunk row is one
assignment on the kernel's scenario axis, its (f, p, rho) grid on the
candidate axis, with the feasibility mask on. Flat candidate g decodes as
f = g // (Lp^N Lr), p = (g // Lr) % Lp^N, rho = g % Lr.

Only the rates change between chunks: the candidate f, p and rho tiles and
the parameter rows are laid out once per sweep, at the chunk's width; the
device rates of many assignments are computed in one block; and each
chunk's best value and candidate stay on the device until the sweep ends. The first assignment with the least value wins, as in the reference's
strict ``<`` over chunks.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.fedsem_objective import ops
from .system import subcarrier_rate
from .types import Allocation, SystemParams, Weights

#: cap on CHUNK * G * N elements per batched evaluation (~8 MB fp32 tiles):
#: bounds peak memory while keeping chunks wide enough to amortise dispatch
_CHUNK_BUDGET = 2_000_000


def default_chunk(G: int, N: int) -> int:
    """Assignments per kernel launch when ``chunk`` is not given: as many as
    keep CHUNK * G * N within `_CHUNK_BUDGET`, between 1 and 64."""
    return int(max(1, min(64, _CHUNK_BUDGET // max(G * N, 1))))


class ExhaustiveResult(NamedTuple):
    alloc: Allocation
    value: torch.Tensor
    n_evaluated: int


def power_levels_watt(p_levels_dbm) -> np.ndarray:
    """dBm levels -> float32 W as the reference's float32 ``dbm_to_watt``
    rounds them: (dBm - 30) / 10 in float32, then 10 to that power rounded
    once to float32."""
    t = (np.asarray(p_levels_dbm, np.float32) - np.float32(30.0)) / np.float32(10.0)
    return (10.0 ** t.astype(np.float64)).astype(np.float32)


def solve_exhaustive(
    params: SystemParams,
    weights: Weights,
    f_levels: np.ndarray,
    p_levels_dbm: np.ndarray,
    rho_levels: np.ndarray,
    accuracy_ab=(0.6356, 0.4025),
    chunk: int | None = None,
    use_kernel: str | bool = "auto",
) -> ExhaustiveResult:
    """Enumerate all N^K assignments of one scenario; grid-sweep (f, p, rho)
    per assignment.

    ``chunk`` overrides how many assignments ride one batched kernel call
    (default: sized so a chunk's candidate tile stays ~a few MB).
    ``use_kernel`` is `ops.objective_grid_batch`'s: the CUDA kernel for a
    scenario on the card ("auto"), the plain version (False).
    """
    if params.g.ndim != 2:
        raise ValueError(
            f"solve_exhaustive takes one scenario, g of shape (N, K); got {tuple(params.g.shape)}"
        )
    N, K = params.N, params.K
    if N**K > 2_000_000:
        raise ValueError(f"exhaustive X enumeration too large: N^K = {N}^{K}")
    dev = params.device

    f_levels = np.asarray(f_levels, np.float32)
    p_levels = power_levels_watt(p_levels_dbm)
    rho_levels = np.asarray(rho_levels, np.float32)

    # per-device candidate tuples (f, p) — meshgrid over devices
    f_mesh = np.stack(
        np.meshgrid(*([f_levels] * N), indexing="ij"), -1
    ).reshape(-1, N)                                      # (Lf^N, N)
    p_idx = np.stack(
        np.meshgrid(*([np.arange(len(p_levels))] * N), indexing="ij"), -1
    ).reshape(-1, N)                                      # (Lp^N, N)
    p_mesh = p_levels[p_idx]                              # (Lp^N, N)

    A_, B_, Lr = len(f_mesh), len(p_mesh), len(rho_levels)
    G = A_ * B_ * Lr                                      # candidates / assignment
    if chunk is None:
        chunk = default_chunk(G, N)

    owners_np = np.fromiter(
        itertools.chain.from_iterable(itertools.product(range(N), repeat=K)),
        np.int32,
    ).reshape(-1, K)                                      # (N^K, K)
    m = len(owners_np)
    m_pad = -(-m // chunk) * chunk
    # padded tail rows replicate the last assignment; they stay out of the
    # argmin below
    owners_pad = np.concatenate(
        [owners_np, np.repeat(owners_np[-1:], m_pad - m, axis=0)]
    )

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def row(x):
        """(N,) or () per scenario -> the chunk's (CH, N) or (CH,) rows."""
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.expand((chunk,) + tuple(x.shape)).contiguous()

    # candidate grid shared by every assignment (flat index g = (a, b, r)):
    # f repeats over (p, rho), p tiles over f / repeats over rho, rho tiles
    fs = row(on_dev(f_mesh).repeat_interleave(B_ * Lr, dim=0))            # (CH, G, N)
    ps = row(on_dev(p_mesh).repeat_interleave(Lr, dim=0).repeat(A_, 1))
    rho_c = row(on_dev(rho_levels).repeat(A_ * B_))                       # (CH, G)
    rows = [row(getattr(params, n)) for n in ("c", "d", "D", "C", "t_sc_max", "f_max")]
    kappas = [row(k) for k in (weights.kappa1, weights.kappa2, weights.kappa3)]
    acc = tuple(row(v) for v in accuracy_ab)
    dev_mask = row(params.dev_mask)

    owners = on_dev(owners_pad.astype(np.int64))                          # (m_pad, K)
    p_lv = on_dev(p_levels)[None, :, None, None]                          # (1, Lp, 1, 1)
    p_idx_t = on_dev(p_idx.astype(np.int64))                              # (B_, N)
    dev_ids = torch.arange(N, device=dev)

    def rates(owner):
        """(R, K) owners -> (R, B_, N): each device's rate at its power level
        of each p-candidate, the power spread equally over its subcarriers."""
        X = (owner[:, None, :] == dev_ids[:, None]).to(torch.float32)     # (R, N, K)
        n_sc = torch.clamp_min(torch.sum(X, dim=-1), 1.0)                 # (R, N)
        # rate table: (R, Lp, N) — device rate at total power level p
        P_tab = (p_lv / n_sc[:, None, :, None]) * X[:, None]
        r_tab = torch.sum(X[:, None] * subcarrier_rate(params, P_tab), dim=-1)
        return r_tab[:, p_idx_t, dev_ids]

    # the rates of many chunks at once (a block's rate table within the
    # budget), so a chunk only lays out its (CH, G, N) rate tile
    block = chunk * max(1, _CHUNK_BUDGET // (chunk * len(p_levels) * N * K))
    # the chunk's rate tile, rewritten in place for every chunk
    r_c = torch.empty((chunk, G, N), dtype=torch.float32, device=dev)
    score = ops.bound_objective_grid_batch(
        fs, ps, r_c, rho_c, *rows, *kappas,
        xi=float(params.xi), eta=float(params.eta),
        accuracy_ab=acc,
        # padded scenarios (`pad_params`) score like their exact-shape
        # twin: real device count, masked reductions, masked feasibility
        dev_mask=dev_mask,
        check_feasible=True,
        use_kernel=use_kernel,
    )
    best_vals, best_gs = [], []
    for lo in range(0, m_pad, chunk):
        if lo % block == 0:
            rs_block = rates(owners[lo : lo + block])                     # (<= block, B_, N)
        rs = rs_block[lo % block : lo % block + chunk]                    # (CH, B_, N)
        # r_c[:, (a, b, r)] = rs[:, b]
        r_c.view(chunk, A_, B_, Lr, N).copy_(rs[:, None, :, None, :].expand(chunk, A_, B_, Lr, N))
        obj = score()                                                     # (CH, G)
        v, g = torch.min(obj, dim=-1)
        best_vals.append(v)
        best_gs.append(g)

    vals = torch.cat(best_vals)[:m]
    best_owner_i = int(torch.argmin(vals))        # the first assignment on ties
    best_val = float(vals[best_owner_i])
    if not best_val < np.inf:
        raise ValueError(
            "solve_exhaustive: every candidate in the grid is infeasible "
            "(all objectives +inf) — the SemCom deadline t_sc_max or f_max "
            "cannot be met at any grid point; widen the f/p/rho levels"
        )
    best_g = int(torch.cat(best_gs)[best_owner_i])
    owner = owners_np[best_owner_i]
    f_c = f_mesh[best_g // (B_ * Lr)]
    p_c = p_mesh[(best_g // Lr) % B_]
    rho_best = rho_levels[best_g % Lr]
    X = np.zeros((N, K), np.float32)
    X[owner, np.arange(K)] = 1.0
    n_sc = np.maximum(X.sum(-1), 1.0)
    P = X * (p_c / n_sc)[:, None]
    alloc = Allocation(
        f=on_dev(f_c), P=on_dev(P), X=on_dev(X),
        rho=torch.tensor(rho_best, dtype=torch.float32, device=dev),
    )
    return ExhaustiveResult(
        alloc=alloc,
        value=torch.tensor(best_val, dtype=torch.float32, device=dev),
        n_evaluated=m * G,
    )
