"""Upload-size accounting shared by the FL driver and the SemCom codec.

Counterpart of `repro.core.bits`: the allocator's D_n (bits a client
uploads per round) means the same thing wherever it is computed, so
`fl.federated` and `semcom.autoencoder` both size their trees here.
"""
from __future__ import annotations

import math

from .types import tree_leaves


def tree_bits(tree, bits_per_param: int = 32) -> float:
    """Total size of a tree's tensors in bits (float32 by default): the FL
    upload size D_n the allocator prices."""
    return float(sum(math.prod(x.shape) for x in tree_leaves(tree)) * bits_per_param)
