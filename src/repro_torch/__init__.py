"""FedSem in PyTorch and CUDA: the port of the JAX package `repro`.

The module names follow the reference's (`core/types.py`, `core/system.py`,
`kernels/fedsem_objective/...`), so each module's counterpart is easy to
find. The package imports torch, numpy and the standard library only.
"""
