"""alloc_pgd_s_per_solve: device seconds of the program's `pgd` spans (the
Adam steps of `core/pgd.py:solve_p4_pgd`: each outer iteration's and the
full-payload start's) per `solve_batch`."""
from fedbench.yardstick import program_spans


def read(rec):
    return program_spans.per_solve_s(rec, "pgd")
