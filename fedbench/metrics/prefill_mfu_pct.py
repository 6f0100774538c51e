"""prefill_mfu_pct: the window's prefills' model FLOPs (`counting.prefill_flops`:
2 x the matmul parameters x tokens, attention's 4 hd per kept pair and head,
WKV6's operations) over the window's wall time and the bf16 dense peak."""
from fedbench.yardstick import counting, peaks


def read(rec):
    if rec.kind != "prefill" or not rec.lengths:
        return None
    flops = sum(counting.prefill_flops(rec.model, rec.matmul_params, L) for L in rec.lengths)
    return 100.0 * flops / rec.window_s / peaks.BF16_FLOPS_PER_S
