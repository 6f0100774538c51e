"""device_idle_pct.alloc: the share of the traced allocation window (whole
solves) in which no kernel ran."""


def read(rec):
    if rec.kind != "fl_alloc" or rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
