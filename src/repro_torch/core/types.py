"""Dataclasses of tensors for the FedSem wireless system (paper Table I).

Counterpart of `repro.core.types`. Data fields are float32 tensors that may
carry leading batch axes (a stacked batch of scenarios, or scenarios x
multi-start rows inside `solve_batch`); meta fields are python scalars that
every row of a batch shares. Every function in `repro_torch.core` reduces
over explicit trailing axes, so one code path serves one scenario and a
batch alike.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# unit helpers
# ---------------------------------------------------------------------------


def dbm_to_watt(dbm, device=None):
    return 10.0 ** ((torch.as_tensor(dbm, dtype=torch.float32, device=device) - 30.0) / 10.0)


#: the leaves of a tree
ARRAYS = (torch.Tensor, np.ndarray)


def _is_tree(x) -> bool:
    """Whether ``x`` is an array or a container the tree functions walk
    (python scalars, the meta fields, are not)."""
    return isinstance(x, (*ARRAYS, dict, list, tuple)) or dataclasses.is_dataclass(x)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every array leaf (tensor or numpy array) of a tree.

    A tree is an array, None, or a dataclass, NamedTuple, dict, list or
    tuple of trees. A dataclass's non-tree fields (the meta scalars) and
    None pass through from ``tree``. With ``rest``, ``fn`` receives the
    matching leaves of every argument.
    """
    if isinstance(tree, ARRAYS):
        return fn(tree, *rest)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        changes = {
            fld.name: tree_map(fn, getattr(tree, fld.name), *(getattr(r, fld.name) for r in rest))
            for fld in dataclasses.fields(tree)
            if _is_tree(getattr(tree, fld.name))
        }
        return dataclasses.replace(tree, **changes)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"tree_map: unsupported leaf type {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The array leaves of a tree, in `tree_map`'s order (dicts by
    insertion order)."""
    if isinstance(tree, ARRAYS):
        return [tree]
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
        return [x for c in children if _is_tree(c) for x in tree_leaves(c)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    raise TypeError(f"tree_leaves: unsupported leaf type {type(tree).__name__}")


#: the `SystemParams` fields that are tensors
PARAM_FIELDS = (
    "g", "c", "d", "D", "C", "p_max", "f_max", "t_sc_max", "dev_mask", "sc_mask",
)
#: the `SystemParams` fields every row of a batch must share
META_FIELDS = ("N", "K", "B", "N0", "xi", "eta", "q")


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Static description of one FedSem wireless scenario (or a batch).

    Shapes: ``g`` is (..., N, K) channel gain (linear); ``c, d, D, C,
    p_max, f_max, t_sc_max`` are (..., N).

    ``dev_mask`` (..., N) / ``sc_mask`` (..., K) are {0,1} validity masks of
    the serving layer's shape buckets (`pad_params`): real devices and
    subcarriers occupy the leading indices, padded ones carry mask 0 and do
    not perturb the objective or the hardened allocation. They default to
    ones on ``g``'s device.

    Meta (python scalars): N devices, K subcarriers, B total bandwidth [Hz],
    N0 noise PSD [W/Hz], xi effective switched capacitance, eta local
    iterations, q binary-tightening exponent of (35a).
    """

    g: torch.Tensor
    c: torch.Tensor         # CPU cycles / sample
    d: torch.Tensor         # samples per device
    D: torch.Tensor         # FL upload size [bits]
    C: torch.Tensor         # total SemCom payload L * C_{n,l} [bits]
    p_max: torch.Tensor     # [W]
    f_max: torch.Tensor     # [Hz]
    t_sc_max: torch.Tensor  # SemCom deadline [s]
    dev_mask: torch.Tensor | None = None   # (..., N) 1 = real device, 0 = padding
    sc_mask: torch.Tensor | None = None    # (..., K) 1 = real subcarrier, 0 = padding
    N: int = 10
    K: int = 50
    B: float = 20e6
    N0: float = 10.0 ** ((-174.0 - 30.0) / 10.0)
    xi: float = 1e-28
    eta: int = 10
    q: int = 2

    def __post_init__(self):
        lead = tuple(self.g.shape[:-2])
        if self.dev_mask is None:
            object.__setattr__(
                self, "dev_mask",
                torch.ones(lead + (self.N,), dtype=torch.float32, device=self.g.device),
            )
        if self.sc_mask is None:
            object.__setattr__(
                self, "sc_mask",
                torch.ones(lead + (self.K,), dtype=torch.float32, device=self.g.device),
            )
        # (13d) gives each subcarrier to at most one device and `harden_x`
        # guarantees every device one subcarrier: both need K >= N
        if self.K < self.N:
            raise ValueError(
                f"SystemParams requires K >= N (each of the N={self.N} devices "
                f"needs at least one of the K={self.K} subcarriers to satisfy "
                "the rate floor); got K < N"
            )

    @property
    def bbar(self) -> float:
        """Per-subcarrier bandwidth B/K [Hz]."""
        return self.B / self.K

    @property
    def noise_sc(self) -> float:
        """Noise power per subcarrier N0 * Bbar [W]."""
        return self.N0 * self.bbar

    @property
    def device(self) -> torch.device:
        return self.g.device


def stack_params(params_list) -> SystemParams:
    """Stack scenarios over a new leading batch axis.

    All scenarios must share the meta fields (N, K, B, N0, xi, eta, q).
    Shapes become ``g: (B, N, K)`` and ``(B, N)`` for the per-device vectors.
    """
    params_list = list(params_list)
    if not params_list:
        raise ValueError("stack_params needs at least one SystemParams")
    ref = params_list[0]
    for i, p in enumerate(params_list[1:], start=1):
        bad = [f for f in META_FIELDS if getattr(p, f) != getattr(ref, f)]
        if bad:
            raise ValueError(
                f"stack_params: scenario {i} differs from scenario 0 in static "
                f"field(s) {bad}; batched solves require identical meta"
            )
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def tree_index(tree, i):
    """Select row ``i`` from a batch-stacked dataclass (inverse of stack)."""
    return tree_map(lambda x: x[i], tree)


@dataclasses.dataclass(frozen=True)
class Weights:
    """Objective weights (kappa1 [1/J], kappa2 [1/s], kappa3 [unitless])."""

    kappa1: torch.Tensor
    kappa2: torch.Tensor
    kappa3: torch.Tensor

    @staticmethod
    def ones(device=None) -> "Weights":
        one = torch.ones((), dtype=torch.float32, device=device)
        return Weights(one, one, one)


def stack_weights(weights_list) -> Weights:
    """Stack per-scenario `Weights` over a new leading batch axis (feeds
    ``solve_batch(..., weights_batched=True)``)."""
    weights_list = list(weights_list)
    if not weights_list:
        raise ValueError("stack_weights needs at least one Weights")
    return tree_map(lambda *xs: torch.stack(xs), *weights_list)


@dataclasses.dataclass(frozen=True)
class Allocation:
    """Decision variables of problem P1.

    f: (..., N) CPU frequency [Hz]; P: (..., N, K) transmit power [W];
    X: (..., N, K) subcarrier indicator (relaxed in [0,1] inside the solver,
    binary at the end); rho: (...) compression rate in (0, 1].
    """

    f: torch.Tensor
    P: torch.Tensor
    X: torch.Tensor
    rho: torch.Tensor


# ---------------------------------------------------------------------------
# shape buckets: the serving layer's padding contract
# ---------------------------------------------------------------------------


class ShapeBucket(NamedTuple):
    """Canonical padded (N, K) shape. Solving a `pad_params`-padded scenario
    yields the same hardened assignment as solving the exact-shape one."""

    N: int
    K: int

    @property
    def area(self) -> int:
        """Padded problem area N*K: solve time scales with the padded shape."""
        return self.N * self.K

    def fits(self, n: int, k: int) -> bool:
        """Whether an (n, k) scenario can pad into this bucket."""
        return self.N >= n and self.K >= k


#: default bucket ladder of the serving layer (same as the reference's)
DEFAULT_BUCKETS = (
    ShapeBucket(4, 8),
    ShapeBucket(4, 16),
    ShapeBucket(8, 16),
    ShapeBucket(8, 32),
    ShapeBucket(16, 64),
    ShapeBucket(32, 128),
    ShapeBucket(64, 256),
)


def bucket_for(n: int, k: int, buckets=DEFAULT_BUCKETS) -> ShapeBucket:
    """Smallest bucket (by padded area N*K) that fits an (n, k) scenario."""
    fits = [b for b in buckets if b.fits(n, k)]
    if not fits:
        raise ValueError(
            f"no bucket in {tuple(buckets)} fits a scenario with N={n}, K={k}; "
            "extend the bucket ladder"
        )
    return min(fits, key=lambda b: (b.area, b.N))


def pad_params(params: SystemParams, n_pad, k_pad: int | None = None) -> SystemParams:
    """Pad a scenario to a canonical (n_pad, k_pad) bucket with validity masks.

    Accepts ``pad_params(params, bucket)`` or ``pad_params(params, N, K)``.
    Padded entries are inert: zero gain, ``d = D = C = 0``, zero masks, and
    ``B`` rescaled so ``bbar = B/K`` is preserved exactly.
    """
    if k_pad is None:
        n_pad, k_pad = n_pad  # a ShapeBucket / (N, K) tuple
    if n_pad < params.N or k_pad < params.K:
        raise ValueError(
            f"pad_params cannot shrink: scenario is (N={params.N}, K={params.K}), "
            f"requested bucket ({n_pad}, {k_pad})"
        )
    if n_pad == params.N and k_pad == params.K:
        return params
    dn, dk = n_pad - params.N, k_pad - params.K

    def pad_n(x, fill=0.0):
        return F.pad(x, (0, dn), value=fill)

    return SystemParams(
        g=F.pad(params.g, (0, dk, 0, dn)),
        c=pad_n(params.c, 1.0),          # value irrelevant: d = 0 zeroes comp terms
        d=pad_n(params.d),
        D=pad_n(params.D),
        C=pad_n(params.C),
        p_max=pad_n(params.p_max, 1.0),  # positive: avoids 0-division in solvers
        f_max=pad_n(params.f_max, 1.0),
        t_sc_max=pad_n(params.t_sc_max, 1.0),
        dev_mask=pad_n(params.dev_mask),
        sc_mask=F.pad(params.sc_mask, (0, dk)),
        N=n_pad,
        K=k_pad,
        B=params.bbar * k_pad,           # preserve bbar = B/K exactly
        N0=params.N0,
        xi=params.xi,
        eta=params.eta,
        q=params.q,
    )


def unpad_alloc(alloc: Allocation, n: int, k: int) -> Allocation:
    """Slice the real (n, k) block back out of a padded `Allocation` (leading
    batch axes are left alone)."""
    return Allocation(
        f=alloc.f[..., :n],
        P=alloc.P[..., :n, :k],
        X=alloc.X[..., :n, :k],
        rho=alloc.rho,
    )
