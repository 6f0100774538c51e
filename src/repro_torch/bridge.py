"""Carry state between numpy and the port's dataclasses and modules.

The parity tests make one set of numpy arrays and hand it to both packages;
this module is the port's side of that crossing (the JAX side converts its
own pytrees). Nothing here imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.accuracy import AccuracyFn
from .core.types import META_FIELDS, PARAM_FIELDS, Allocation, SystemParams, Weights
from .device import resolve_device


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)


def params_from_numpy(arrays: dict, meta: dict, device="cuda") -> SystemParams:
    """`SystemParams` from numpy arrays keyed by field name (``dev_mask`` and
    ``sc_mask`` optional) and a dict of the meta fields."""
    dev = resolve_device(device)
    unknown = set(arrays) - set(PARAM_FIELDS)
    if unknown:
        raise ValueError(f"params_from_numpy: unknown array field(s) {sorted(unknown)}")
    data = {k: _tensor(v, dev) for k, v in arrays.items() if v is not None}
    return SystemParams(**data, **{k: meta[k] for k in META_FIELDS if k in meta})


def weights_from_numpy(arrays: dict, device="cuda") -> Weights:
    """`Weights` from ``{"kappa1", "kappa2", "kappa3"}`` scalars or (B,) arrays."""
    dev = resolve_device(device)
    return Weights(*(_tensor(arrays[k], dev) for k in ("kappa1", "kappa2", "kappa3")))


def accuracy_from_numpy(arrays: dict, device="cuda") -> AccuracyFn:
    """`AccuracyFn` from ``{"a", "b"}`` scalars or (B,) arrays (e.g. the
    reference's `fit_power_law` result, for a refit pushed into the port)."""
    dev = resolve_device(device)
    return AccuracyFn(_tensor(arrays["a"], dev), _tensor(arrays["b"], dev))


def allocation_from_numpy(arrays: dict, device="cuda") -> Allocation:
    """`Allocation` from ``{"f", "P", "X", "rho"}`` arrays."""
    dev = resolve_device(device)
    return Allocation(*(_tensor(arrays[k], dev) for k in ("f", "P", "X", "rho")))


def allocation_to_numpy(alloc: Allocation) -> dict:
    """``{"f", "P", "X", "rho"}`` numpy arrays of an `Allocation`."""
    return {
        k: getattr(alloc, k).detach().cpu().numpy() for k in ("f", "P", "X", "rho")
    }


def ae_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The port's codec parameters (`semcom.init_params`' layout) from the
    reference's pytree as numpy arrays: each layer's HWIO filter ``w``
    becomes OIHW, its bias ``b`` stays as it is."""
    dev = resolve_device(device)
    return {
        name: {"w": _tensor(np.transpose(layer["w"], (3, 2, 0, 1)), dev),
               "b": _tensor(layer["b"], dev)}
        for name, layer in tree.items()
    }


def images_from_numpy(x, device="cuda") -> torch.Tensor:
    """An NHWC array (the reference's images, or a latent's noise draw) as
    the port's NCHW float32 tensor."""
    return _tensor(np.transpose(np.asarray(x), (0, 3, 1, 2)), resolve_device(device))


def lm_tree_from_numpy(tree: dict, cfg, device="cuda", dtype=None) -> dict:
    """The port's LM tree (``models.model.LM.tree``, laid out as the
    reference's) from the reference's parameter pytree, or from a pytree
    laid out like it (an optimizer's moments).

    ``tree`` is `repro.models.model.init_params`'s pytree as numpy arrays:
    ``embed``, ``final_ln``, optional ``head`` and ``frontend_proj``, and
    ``stages[name]["b{j}"]`` whose leaves carry a leading period axis. Arrays go through float32
    (exact for bfloat16, which numpy holds as ``ml_dtypes.bfloat16``) and
    then to ``dtype``; with None, to the config's dtype, except the leaves
    the reference keeps in float32, which stay float32 in a bfloat16 model:
    the Mamba leaves of `models.mamba.FLOAT32_LEAVES` and the MoE router.
    """
    from .models.layers import dtype_of
    from .models.mamba import leaf_dtype
    from .models.model import check_ported

    check_ported(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg) if dtype is None else dtype

    def convert(node, name=None, mamba=False):
        if isinstance(node, dict):
            return {k: convert(v, k, mamba or k == "mamba") for k, v in node.items()}
        to = dt
        if dtype is None and mamba:
            to = leaf_dtype(name, dt)
        elif dtype is None and name == "router":
            to = torch.float32
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(device=dev, dtype=to)

    keys = ("embed", "final_ln", "head", "frontend_proj", "stages")
    return {k: convert(tree[k]) for k in keys if k in tree}


def lm_params_from_numpy(tree: dict, cfg, device="cuda"):
    """The port's `models.model.LM` from the reference's parameter pytree:
    layer ``offset + period * pattern_len + j`` takes period ``period`` of
    block ``b{j}`` (the `LM` over `lm_tree_from_numpy`'s tree)."""
    from .models.model import LM

    return LM(cfg, lm_tree_from_numpy(tree, cfg, device))


def lm_params_to_numpy(params) -> dict:
    """The reference's parameter pytree from the port's `LM` or its tree
    (or a tree laid out like it: gradients, moments), as float32 numpy
    arrays (exact for bfloat16): the inverse of `lm_params_from_numpy`, for
    comparing leaf by leaf."""
    from .models.model import LM

    tree = params.tree if isinstance(params, LM) else params

    def arr(node):
        if isinstance(node, dict):
            return {k: arr(v) for k, v in node.items()}
        return node.detach().float().cpu().numpy()

    return arr(tree)


def opt_state_from_numpy(state, cfg, device="cuda"):
    """The port's `optim.OptState` from the reference's (``step``, and the
    moments ``mu``/``nu`` laid out like its parameter pytree, as numpy
    arrays; None for an optimizer without them): the step as an int32 host
    scalar (as the port's ``init`` makes it), the moments as float32 tree
    views on ``device`` (`lm_tree_from_numpy`)."""
    from .optim.optimizers import OptState

    dev = resolve_device(device)
    moments = lambda t: None if t is None else lm_tree_from_numpy(t, cfg, dev, torch.float32)
    return OptState(step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
                    mu=moments(state.mu), nu=moments(state.nu))
