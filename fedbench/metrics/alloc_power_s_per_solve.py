"""alloc_power_s_per_solve: device seconds of the program's `power_given_x`
spans (the Adam steps that re-solve the powers after X is hardened,
`core/pgd.py:power_given_x`) per `solve_batch`."""
from fedbench.yardstick import program_spans


def read(rec):
    return program_spans.per_solve_s(rec, "power_given_x")
