"""fedbench: the benchmark of `repro_torch`, the PyTorch and CUDA port.

Run one cell of `BENCHMARK.json` with
``python3 -m fedbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout (README.md beside this file). Nothing here
imports `jax`, `jaxlib` or the JAX package `repro`.
"""
