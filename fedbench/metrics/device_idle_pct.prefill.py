"""device_idle_pct.prefill: the share of the traced prefill window in which
no kernel ran (one minus the union of the kernels' intervals)."""


def read(rec):
    if rec.kind != "prefill" or rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
