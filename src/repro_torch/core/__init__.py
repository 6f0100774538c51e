"""FedSem core in PyTorch: the paper's resource-allocation contribution.

Counterpart of `repro.core`, with the same public names for the ported
pieces; the paper's baselines are `core.baselines`, the exhaustive oracle
`core.exhaustive`; warm starts are `ExtraStart` and `refine_with_start`;
scenario sharding (the ``mesh=`` argument) is `core.distribute`.
"""
from .accuracy import AccuracyFn, default_accuracy, fit_power_law, stack_accuracy
from .allocator import (
    AllocatorConfig, AllocatorResult, ExtraStart, refine_with_start, sanitize_start,
    solve, solve_batch,
)
from .bits import tree_bits
from .channel import sample_params, sample_params_batch, sample_request_stream
from .distribute import pad_batch, scenario_mesh, shard_batch, slice_batch
from .scoring import batch_objectives, candidate_objectives, scenario_objective
from .types import (
    DEFAULT_BUCKETS, Allocation, ShapeBucket, SystemParams, Weights,
    bucket_for, dbm_to_watt, pad_params, stack_params, stack_weights,
    tree_index, unpad_alloc,
)

__all__ = [
    "AccuracyFn", "default_accuracy", "fit_power_law", "stack_accuracy", "tree_bits",
    "pad_batch", "scenario_mesh", "shard_batch", "slice_batch",
    "AllocatorConfig", "AllocatorResult", "ExtraStart", "refine_with_start",
    "sanitize_start", "solve", "solve_batch",
    "sample_params", "sample_params_batch", "sample_request_stream",
    "batch_objectives", "candidate_objectives", "scenario_objective",
    "Allocation", "SystemParams", "Weights", "dbm_to_watt",
    "stack_params", "stack_weights", "tree_index",
    "ShapeBucket", "DEFAULT_BUCKETS", "bucket_for", "pad_params", "unpad_alloc",
]
