"""Production meshes, a mesh on the card, and the card's constants.

Counterpart of `repro.launch.mesh`. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the reference's axis names:
``("data", "model")``, or ``("pod", "data", "model")`` across pods. Batches
shard on the data axes, weights on ``model`` (`parallel.sharding`).

`make_production_mesh` keeps the reference's shapes, (16, 16) and
(2, 16, 16), so that dry-run records compare with the reference's one to
one. It needs a process group of at least that world: the dry run
(`launch.dryrun`) opens a fake one of 256 or 512 ranks in its own process,
as the reference forces 512 host devices. A 16-wide model axis spans two
8-card NVLink nodes, so the link term below is a lower bound there.

`open_mesh` opens a real mesh of this process alone: a one-process group
through a `FileStore` in a temporary directory (no network), on the card
unless the caller asks for the CPU, as the tests do.

Functions, not module constants: importing this module touches no process
group and no device.
"""
from __future__ import annotations

import math
import os
import tempfile

import torch

# The card's spec-sheet figures: NVIDIA H100 80GB HBM3 (SXM5, 700 W).
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12                # bytes/s per card
LINK_BW = 450e9                 # NVLink bytes/s per card and direction
HBM_BYTES = 80 * 10**9          # 80 GB per card


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) or (2, 16, 16) mesh over the default process group's
    first ranks. Raises when the world is smaller than the mesh; never
    shrinks it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; the process group has {world}: run under "
            "launch/dryrun.py, which opens a fake group of 512 ranks"
        )
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def open_mesh(shape=(1, 1), axes=("data", "model"), device_type: str = "cuda"):
    """A mesh of this process alone (every axis of size 1), in a one-process
    group opened here through a `FileStore` (``nccl`` on the card, ``gloo``
    on the CPU) unless a group is already open. On the card the current
    device is set to card 0; a missing card raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if math.prod(shape) != 1:
        raise ValueError(f"open_mesh opens a one-process mesh; {shape} has {math.prod(shape)} ranks")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on the card needs CUDA; pass device_type='cpu' for the CPU")
        torch.cuda.set_device(0)
    if not dist.is_initialized():
        path = os.path.join(tempfile.mkdtemp(prefix="mesh_"), "store")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.FileStore(path, 1), rank=0, world_size=1)
    return DeviceMesh(device_type, torch.zeros(shape, dtype=torch.long), mesh_dim_names=tuple(axes))
