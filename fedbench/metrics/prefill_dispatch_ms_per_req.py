"""prefill_dispatch_ms_per_req: mean host time of the program's `prefill`
root span (entry to return, before the caller's synchronize) over the
window's requests of the traffic's shortest prompt, where the host sets the
pace. Read in the traced run, so it holds the profiler's cost per launch."""
from fedbench.yardstick import program_spans


def read(rec):
    return program_spans.dispatch_ms(rec)
