"""prefill_other_us_per_tok: device time per prompt token of every kernel
that is neither a matrix product nor one of the port's hand-written kernels:
the eager elementwise operations, norms, copies and reductions."""
from fedbench.yardstick import names


def read(rec):
    if rec.kind != "prefill" or rec.trace is None or not rec.lengths:
        return None
    _, secs = names.device_seconds(
        rec.trace["kernels"], lambda n: not names.is_product(n) and not names.is_port_kernel(n))
    return 1e6 * secs / sum(rec.lengths) if secs > 0 else None
