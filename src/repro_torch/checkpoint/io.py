"""Tree checkpointing to ``.npz``.

Counterpart of `repro.checkpoint.io`. A tree is a tensor or a nested dict,
list, tuple or NamedTuple of them (None is an empty subtree). Leaves are
stored under the reference's key paths (`jax.tree_util.keystr` of each
path entry, joined by "/": ``['embed']`` for a dict key, ``[0]`` for a
list or tuple index, ``.params`` for a NamedTuple field), so a checkpoint
of a dict or list tree written by either package restores in the other.
bfloat16 and float16 leaves are stored as float32 (npz has no bfloat16) and
cast back on restore, which rebuilds the structure, types and devices of a
reference tree (``like``).
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key path entry, child) pairs of a node, in the reference's format."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    raise TypeError(f"checkpoint: unsupported node type {type(tree).__name__}")


def _flatten(tree, prefix=()):
    if tree is None:
        return
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield "/".join(prefix), tree
        return
    for key, child in _children(tree):
        yield from _flatten(child, prefix + (key,))


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()                   # npz-safe; cast back on restore
        return x.cpu().numpy()
    return np.asarray(x)


def save(path: str, tree) -> None:
    """Write every leaf of ``tree`` to ``path`` (through a temporary file,
    replaced at the end, so a crash leaves the old checkpoint)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{key: _to_numpy(leaf) for key, leaf in _flatten(tree)})
    os.replace(tmp, path)


def restore(path: str, like):
    """The tree of ``like``'s structure with the leaves stored at ``path``,
    each in its ``like`` leaf's type and on its device. A leaf missing from
    the file raises `KeyError`; one of another shape, `ValueError`."""
    with np.load(path, allow_pickle=False) as data:

        def build(node, prefix):
            if node is None:
                return None
            if isinstance(node, (torch.Tensor, np.ndarray)):
                key = "/".join(prefix)
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = data[key]
                if tuple(arr.shape) != tuple(node.shape):
                    raise ValueError(f"{key}: shape {tuple(arr.shape)} != {tuple(node.shape)}")
                if isinstance(node, np.ndarray):
                    return arr.astype(node.dtype)
                return torch.from_numpy(arr).to(device=node.device, dtype=node.dtype)
            kids = [build(child, prefix + (key,)) for key, child in _children(node)]
            if isinstance(node, dict):
                return type(node)(zip(node.keys(), kids))
            if _is_namedtuple(node):
                return type(node)(*kids)
            return type(node)(kids)

        return build(like, ())
