"""repro_torch.fl: the FL substrate, its pluggable allocation backends, and
the closed-loop SemCom training job.

Counterpart of `repro.fl`; `round_channel_seed` and `fold_seed` take the
place of the reference's JAX-key helpers.
"""
from .alloc_backend import (
    AllocationBackend, PlannedBackend, ServiceBackend, serve_config_for,
)
from .federated import (
    FLConfig, RoundStats, fold_seed, plan_allocations, round_channel_seed, run_fl,
    sample_round_scenarios, topk_sparsify, tree_bits,
)
from .semcom_job import SemComJob, SemComJobConfig, SemComJobResult

__all__ = [
    "AllocationBackend", "PlannedBackend", "ServiceBackend", "serve_config_for",
    "FLConfig", "RoundStats", "fold_seed", "plan_allocations", "round_channel_seed",
    "run_fl", "sample_round_scenarios", "topk_sparsify", "tree_bits",
    "SemComJob", "SemComJobConfig", "SemComJobResult",
]
