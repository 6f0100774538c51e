"""Scenario-parallel sharding for the batched allocator.

Counterpart of `repro.core.distribute`. `solve_batch` solves every scenario
of a batch independently, so the batch splits over devices with no
communication between them. The reference builds a 1-D `jax.sharding.Mesh`
and lets XLA partition one program; here a mesh is a tuple of
`torch.device`s, and `solve_batch(..., mesh=...)` pads the batch to a
multiple of the mesh size (`pad_batch`, replicating the tail scenario),
splits its leading axis into one chunk per device (`shard_batch`), solves
each chunk on its device, gathers the results onto the params' device
(`gather_batch`) and slices the padding off (`slice_batch`). On one card
the mesh has one device and sharding is the identity, through the same
pad, split, solve, gather and slice.

The trees are `core.types.tree_map`'s: here `SystemParams`, `Weights`,
`AccuracyFn`, `AllocatorResult` and `ExtraStart` (whose leaves may be
numpy arrays, which stay numpy); meta fields and None pass through.

Equivalence guarantee (`tests/test_torch_distribute.py`): a sharded solve
returns the same hardened assignment X as the single-device solve for
every scenario, including a batch the mesh size does not divide.
"""
from __future__ import annotations

import numpy as np
import torch

from .types import tree_leaves, tree_map


def scenario_mesh(devices=None) -> tuple[torch.device, ...]:
    """The devices a batch shards over (default: every CUDA device).

    ``devices`` is a sequence of `torch.device`s or device strings; the
    CPU tests pass several ``"cpu"`` entries so the split really happens.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "scenario_mesh() defaults to every CUDA device, and CUDA is not "
                "available; pass the devices explicitly (e.g. ['cpu', 'cpu'])"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return check_mesh(devices)


def check_mesh(mesh) -> tuple[torch.device, ...]:
    """``mesh`` as a non-empty tuple of `torch.device`s; anything else raises."""
    if isinstance(mesh, (str, torch.device)) or not isinstance(mesh, (list, tuple)):
        raise TypeError(
            "a scenario mesh is a sequence of torch.device (scenario_mesh()), "
            f"got {type(mesh).__name__}"
        )
    out = []
    for d in mesh:
        if not isinstance(d, (str, torch.device)):
            raise TypeError(
                f"a scenario mesh holds torch.device entries, got {type(d).__name__}"
            )
        out.append(torch.device(d))
    if not out:
        raise ValueError("a scenario mesh needs at least one device")
    return tuple(out)


def round_up(b: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``b``."""
    return -(-b // multiple) * multiple


def pad_batch(tree, to_size: int):
    """Pad every leaf's leading axis to ``to_size`` by replicating the tail.

    The per-scenario solves are independent, so the replicas are throwaway
    work: `slice_batch` takes them off again.
    """

    def leaf(x):
        b = x.shape[0]
        if b > to_size:
            raise ValueError(f"pad_batch cannot shrink: batch {b} > {to_size}")
        if b == to_size:
            return x
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(x[-1:], to_size - b, axis=0)], axis=0)
        return torch.cat([x, x[-1:].expand((to_size - b,) + tuple(x.shape[1:]))], dim=0)

    return tree_map(leaf, tree)


def slice_batch(tree, b: int):
    """Undo `pad_batch`: keep the first ``b`` entries of every leaf."""
    return tree_map(lambda x: x[:b], tree)


def shard_batch(tree, mesh) -> list:
    """Split the leading axis into one chunk per mesh device, each chunk on
    its device (numpy leaves stay numpy). The axis must divide evenly:
    `pad_batch` to a multiple of the mesh size first."""
    mesh = check_mesh(mesh)
    b = _batch_size(tree)
    if b % len(mesh):
        raise ValueError(f"shard_batch: batch {b} is not a multiple of the mesh size {len(mesh)}")
    per = b // len(mesh)

    def chunk(i, dev):
        def leaf(x):
            x = x[i * per:(i + 1) * per]
            return x if isinstance(x, np.ndarray) else x.to(dev)
        return tree_map(leaf, tree)

    return [chunk(i, dev) for i, dev in enumerate(mesh)]


def gather_batch(chunks: list, device):
    """Concatenate per-device chunks along the leading axis on ``device``
    (the inverse of `shard_batch`)."""
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs], dim=0), *chunks)


def _batch_size(tree) -> int:
    sizes = [x.shape[0] for x in tree_leaves(tree)]
    if not sizes or len(set(sizes)) != 1:
        raise ValueError(f"a batch's leaves must share one leading size, got {sorted(set(sizes))}")
    return sizes[0]


def run_sharded(mesh, fn, params, *trees):
    """``fn(params_chunk, *chunks)`` on each mesh device, every tree's
    leading axis split alike; the results gathered on the params' device
    and sliced to the unpadded batch.

    The chunks run one after another from this thread: the solves are
    host-bound eager work, so threads would take turns on the interpreter
    lock, and the kernels' launch counters stay exact.
    """
    mesh = check_mesh(mesh)
    b = _batch_size(params)
    b_pad = round_up(b, len(mesh))
    padded = [pad_batch(t, b_pad) for t in (params, *trees)]
    shards = [shard_batch(t, mesh) if t is not None else [None] * len(mesh) for t in padded]
    outs = [fn(*args) for args in zip(*shards)]
    return slice_batch(gather_batch(outs, params.device), b)
