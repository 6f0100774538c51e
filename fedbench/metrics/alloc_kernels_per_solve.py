"""alloc_kernels_per_solve: device kernels in the trace per `solve_batch`
(its scoring included): the dispatch a CUDA-graph solver would remove."""


def read(rec):
    if rec.kind != "fl_alloc" or rec.trace is None or rec.solves == 0:
        return None
    launches = sum(c for c, _ in rec.trace["kernels"].values())
    return launches / rec.solves if launches else None
