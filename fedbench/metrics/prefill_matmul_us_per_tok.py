"""prefill_matmul_us_per_tok: device time of the matrix products' kernels
(cuBLAS and CUTLASS names, `names.is_product`) per prompt token."""
from fedbench.yardstick import names


def read(rec):
    if rec.kind != "prefill" or rec.trace is None or not rec.lengths:
        return None
    _, secs = names.device_seconds(rec.trace["kernels"], names.is_product)
    return 1e6 * secs / sum(rec.lengths) if secs > 0 else None
