"""Alg. A2's Adam loops (P4's PGD and the power re-solve): CUDA kernel, dispatch."""
