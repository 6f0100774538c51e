"""A mesh as the model's sharded path sees it, and the collectives that path
uses, each with its gradient.

The port's counterpart of the reference's ``shard_map`` regions: the model
runs on each rank's local tensors (its data shard of the batch, its
``model`` shard of the weights: heads, d_ff, experts, vocab) and crosses
ranks only through the functions below, built on
`torch.distributed._functional_collectives`. Activations between blocks
are replicated over ``model``; their gradients are complete on every model
rank. So:

  * `copy`    identity forward, all-reduce backward: a replicated
              activation entering a computation that differs per model
              rank (a column-parallel product, a rank's slice);
  * `reduce`  all-reduce forward, identity backward: the partial sums of a
              row-parallel product (attention's ``wo``, the FFN's
              ``w_down``, the experts' combine), the vocab-sharded loss's
              statistics;
  * `gather`  all-gather forward, this rank's slice backward: a
              model-sharded activation made whole;
  * `split`   this rank's slice forward, all-gather backward;
  * `gather_data` all-gather over the data axes, reduce-scatter backward.

On the data axes the loss's sums are reduced with `reduce` too: each data
rank's parameter gradients are then its share of the whole batch's, and
the train step sums them (`launch.train`). Every function is the identity
where the axes it crosses have size 1, so a (1, 1) mesh runs the unsharded
arithmetic bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol


def _wait(x):
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


class Par:
    """A `DeviceMesh` with the reference's axis names, as the model's mesh
    path uses it: ``M`` the model axis's size and ``m`` this rank's index
    on it; ``D`` the data axes' (('pod', 'data')) product and ``d`` this
    rank's flat index on them, outermost first."""

    def __init__(self, mesh):
        names = mesh.mesh_dim_names
        if names is None:
            raise ValueError("a mesh needs axis names ('data', 'model') or ('pod', 'data', 'model')")
        coord = mesh.get_coordinate()
        self.mesh = mesh
        self.model_dim = names.index("model") if "model" in names else None
        self.data_dims = tuple(i for i, n in enumerate(names) if n in ("pod", "data"))
        self.M = mesh.size(self.model_dim) if self.model_dim is not None else 1
        self.m = coord[self.model_dim] if self.model_dim is not None else 0
        self.D = math.prod(mesh.size(i) for i in self.data_dims)
        self.d = 0
        for i in self.data_dims:
            self.d = self.d * mesh.size(i) + coord[i]

    @property
    def all_dims(self) -> tuple:
        return tuple(range(self.mesh.ndim))

    def model_dims(self) -> tuple:
        return () if self.M == 1 else (self.model_dim,)

    def sharded(self, local: int, whole: int) -> bool:
        """Whether a dimension of ``whole`` entries is split over ``model``
        (its local size ``local``): sanitized specs keep a dimension that
        the axis does not divide whole."""
        if local == whole:
            return False
        if local * self.M != whole:
            raise ValueError(f"a local dimension of {local} is neither {whole} nor its 1/{self.M}")
        return True


def as_par(mesh):
    """None, a `Par`, or a `DeviceMesh` (made a `Par`)."""
    return mesh if mesh is None or isinstance(mesh, Par) else Par(mesh)


def _sizes(par, dims) -> int:
    return math.prod(par.mesh.size(i) for i in dims)


def _all_reduce(x, par, dims, op="sum"):
    for i in dims:
        if par.mesh.size(i) > 1:
            x = _wait(funcol.all_reduce(x, op, (par.mesh, i)))
    return x


def _all_gather(x, par, dims, dim):
    # innermost axis first, so that blocks end up outermost-axis-major
    for i in reversed(dims):
        if par.mesh.size(i) > 1:
            x = _wait(funcol.all_gather_tensor(x.contiguous(), dim, (par.mesh, i)))
    return x


def _reduce_scatter(x, par, dims, dim):
    for i in dims:
        if par.mesh.size(i) > 1:
            x = _wait(funcol.reduce_scatter_tensor(x.contiguous(), "sum", dim, (par.mesh, i)))
    return x


def _slice(x, par, dims, dim):
    n = _sizes(par, dims)
    idx = 0
    coord = par.mesh.get_coordinate()
    for i in dims:
        idx = idx * par.mesh.size(i) + coord[i]
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dims):
        return _all_reduce(x, par, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dims):
        ctx.par, ctx.dims = par, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.par, ctx.dims), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dims, dim, scatter):
        ctx.par, ctx.dims, ctx.dim, ctx.scatter = par, dims, dim, scatter
        return _all_gather(x, par, dims, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            return _reduce_scatter(g, ctx.par, ctx.dims, ctx.dim), None, None, None, None
        return _slice(g, ctx.par, ctx.dims, ctx.dim).contiguous(), None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, dims, dim):
        ctx.par, ctx.dims, ctx.dim = par, dims, dim
        # a copy, not a view: a view saved for the backward pass would keep
        # the whole of x alive (Mamba's gathered [x, z] block, M times this)
        return _slice(x, par, dims, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.par, ctx.dims, ctx.dim), None, None, None


def _live(par, dims) -> bool:
    return par is not None and _sizes(par, dims) > 1


def reduce(x, par, dims=None):
    """Sum over ``dims`` (default: the model axis); identity backward."""
    dims = par.model_dims() if dims is None and par is not None else dims
    return _Reduce.apply(x, par, dims) if _live(par, dims) else x


def copy(x, par):
    """Identity over the model axis; all-reduce backward."""
    return _Copy.apply(x, par, par.model_dims()) if par is not None and par.M > 1 else x


def gather(x, par, dim: int = -1):
    """All-gather along ``dim`` over the model axis; slice backward."""
    if par is None or par.M == 1:
        return x
    return _Gather.apply(x, par, par.model_dims(), dim % x.ndim, False)


def split(x, par, dim: int = -1):
    """This rank's model slice along ``dim`` (a copy); all-gather backward."""
    if par is None or par.M == 1:
        return x
    return _Split.apply(x, par, par.model_dims(), dim % x.ndim)


def gather_data(x, par, dim: int = 0, dims=None):
    """All-gather along ``dim`` over the data axes (or the mesh dims
    ``dims`` of them); reduce-scatter backward."""
    dims = (par.data_dims if par else ()) if dims is None else dims
    if not _live(par, dims):
        return x
    return _Gather.apply(x, par, dims, dim % x.ndim, True)


def slice_data(x, par, dim: int = 0):
    """This rank's data slice along ``dim`` of a tensor every data rank
    holds whole (a view; the gradient stays this rank's share)."""
    if not _live(par, par.data_dims if par else ()):
        return x
    return _slice(x, par, par.data_dims, dim)


@torch.no_grad()
def max_model(x, par):
    """Elementwise max over the model axis, no gradient."""
    if par is None or par.M == 1:
        return x
    return _all_reduce(x, par, par.model_dims(), "max")


def mean_data(x, par):
    """Mean over the data axes of a value every model rank holds alike;
    the gradient is scaled by 1/D (the mean's own)."""
    if not _live(par, par.data_dims if par else ()):
        return x
    return _Reduce.apply(x, par, par.data_dims) / par.D


@torch.no_grad()
def pick(logits, greedy: bool = True, generator=None) -> list[int]:
    """Each row's next token from decode logits (B, 1, V): its first
    maximum, as `torch.argmax`'s, or with ``greedy=False`` a draw from its
    softmax, the maximum of logits + Gumbel noise (the (B, V) noise drawn
    from ``generator``), as the reference's `jax.random.categorical`. A
    DTensor sharded on the data axes and on vocab over ``model`` is not
    gathered: every rank draws the whole noise and takes its block, each
    shard's first maximum is compared across ``model`` (the first shard
    holding the largest) and the rows are gathered over the data axes."""
    from torch.distributed.tensor import DTensor

    from . import sharding as SH

    sharded = isinstance(logits, DTensor)
    last = (logits.to_local() if sharded else logits)[:, 0, :].float()
    if sharded:
        par = Par(logits.device_mesh)
        spec = SH.spec_of(logits)
    if not greedy:
        B, _, V = logits.shape
        u = torch.rand((B, V), generator=generator, device=last.device)
        noise = -torch.log(-torch.log(u))
        last = last + (SH.local_block(par.mesh, (spec[0], spec[2]), noise) if sharded else noise)
    idx = torch.argmax(last, dim=-1)
    if not sharded:
        return idx.tolist()
    if spec[2] is not None:
        best = torch.gather(last, -1, idx[:, None])[:, 0]
        idx = idx + par.m * last.shape[-1]
        every = _all_gather(torch.stack([best, idx.float()]), par, par.model_dims(), 0)
        every = every.reshape(par.M, 2, -1)
        shard = torch.argmax(every[:, 0], dim=0)
        idx = torch.gather(every[:, 1], 0, shard[None])[0].long()
    if spec[0] is not None:
        idx = _all_gather(idx, par, par.data_dims, 0)
    return idx.tolist()
