"""FedSem core in PyTorch: the paper's resource-allocation contribution.

Counterpart of `repro.core`, with the same public names for the ported
pieces; the paper's baselines are `core.baselines`, the exhaustive oracle
`core.exhaustive`. Not ported yet: warm starts (`ExtraStart`,
`refine_with_start`), scenario sharding (`core.distribute`, the ``mesh=``
argument), the serving request stream (`sample_request_stream`) and
`fit_power_law`.
"""
from .accuracy import AccuracyFn, default_accuracy, stack_accuracy
from .allocator import AllocatorConfig, AllocatorResult, solve, solve_batch
from .channel import sample_params, sample_params_batch
from .scoring import batch_objectives, candidate_objectives, scenario_objective
from .types import (
    DEFAULT_BUCKETS, Allocation, ShapeBucket, SystemParams, Weights,
    bucket_for, dbm_to_watt, pad_params, stack_params, stack_weights,
    tree_index, unpad_alloc,
)

__all__ = [
    "AccuracyFn", "default_accuracy", "stack_accuracy",
    "AllocatorConfig", "AllocatorResult", "solve", "solve_batch",
    "sample_params", "sample_params_batch",
    "batch_objectives", "candidate_objectives", "scenario_objective",
    "Allocation", "SystemParams", "Weights", "dbm_to_watt",
    "stack_params", "stack_weights", "tree_index",
    "ShapeBucket", "DEFAULT_BUCKETS", "bucket_for", "pad_params", "unpad_alloc",
]
