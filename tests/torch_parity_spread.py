"""The port's whole-solve answers against the JAX reference's own rounding
noise.

The reference is not determined by its inputs beyond a few digits (see
ROADMAP.md §3): moving every channel gain by one ulp moves its f, rho, P
and objective. So the continuous leaves of `solve_batch` are held to the
spread of a small reference ensemble over one-ulp copies of the input,
not to a fixed tolerance. `leaf_spread` computes, per leaf and element,

* the planned tolerance (objective rtol 1e-4, f and rho rtol 1e-3, P atol
  1e-3 p_max),
* the reference ensemble's range [lo, hi] and its spread hi - lo,
* ``single``: how far the port's answer on the drawn input lies outside
  [lo, hi],
* ``gap``: how far the port's range over the first ``port_members`` inputs
  lies from [lo, hi] (0 if they overlap): the second witness, which sees
  whether the port is off or only noisy like the reference.

For the objective only the side where the port is worse (above hi)
counts: Alg. A2 is a heuristic, and a feasible allocation with a lower
objective is not a fault. The allocation's own leaves count on both sides.

Run as a script, it prints both, beyond the planned tolerance and in units
of the reference's spread, for the tiny configs of
`tests/test_torch_allocator.py` over a range of seeds:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_parity_spread.py [first last]
"""
import functools
import json
import sys

import numpy as np

LEAVES = ("obj", "f", "rho", "P")


def ulp_inputs(arrays, members, seed):
    """The scenarios with every channel gain moved by at most one ulp: as
    drawn, all up, all down, then random up/down patterns."""
    g = arrays["g"]
    up, down = np.nextafter(g, np.inf), np.nextafter(g, -np.inf)
    gs = [g, up, down]
    rng = np.random.default_rng(seed)
    while len(gs) < members:
        gs.append(np.where(rng.integers(0, 2, g.shape).astype(bool), up, down))
    return [dict(arrays, g=x.astype(np.float32)) for x in gs]


def leaf_spread(jcfg, tcfg, seed, members=6, port_members=3, N=4, K=12, batch=3):
    """{leaf: dict(planned, lo, hi, single, gap)} for one seed (module doc).
    Every objective is the reference's `system.objective` of the allocation,
    so the solvers are compared, not the evaluators."""
    import jax.numpy as jnp
    from repro.core import Allocation
    from repro_torch.core import Weights, solve_batch
    from torch_port_util import both_params, np_, numpy_scenarios

    jsolve, jobj = reference_jitted()
    arrays, meta = numpy_scenarios(seed, N=N, K=K, batch=batch)
    ref, port = [], []
    for i, a in enumerate(ulp_inputs(arrays, members, 100 + seed)):
        pb, tp = both_params(a, meta)
        allocs = [jsolve(pb, jcfg).alloc]
        if i < port_members:
            ta = solve_batch(tp, Weights.ones(), tcfg).alloc
            allocs.append(Allocation(*(jnp.asarray(np_(getattr(ta, k))) for k in ("f", "P", "X", "rho"))))
        for out, al in zip((ref, port), allocs):
            out.append(dict(obj=np.asarray(jobj(pb, al)), f=np.asarray(al.f),
                            rho=np.asarray(al.rho), P=np.asarray(al.P)))
    p_max = arrays["p_max"][..., None]
    result = {}
    for leaf in LEAVES:
        R = np.stack([m[leaf] for m in ref])
        Q = np.stack([m[leaf] for m in port])
        lo, hi = R.min(0), R.max(0)
        if leaf == "P":
            planned = 1e-3 * p_max
        else:
            planned = (1e-4 if leaf == "obj" else 1e-3) * np.abs(R[0])
        if leaf == "obj":
            outside = lambda qlo, qhi: np.maximum(qlo - hi, 0.0)
        else:
            outside = lambda qlo, qhi: np.maximum(np.maximum(qlo - hi, lo - qhi), 0.0)
        result[leaf] = dict(planned=planned, lo=lo, hi=hi, port=Q,
                            single=outside(Q[0], Q[0]), gap=outside(Q.min(0), Q.max(0)))
    return result


@functools.lru_cache(maxsize=None)
def reference_jitted():
    """The reference's `solve_batch` and batched `system.objective`, jitted
    once."""
    import jax
    from repro.core import Weights, solve_batch
    from repro.core.system import objective

    return (jax.jit(lambda p, cfg: solve_batch(p, Weights.ones(), cfg), static_argnums=1),
            jax.jit(jax.vmap(lambda p, a: objective(p, Weights.ones(), a))))


def excess_ratio(dist, r):
    """max over elements of (dist - planned) / spread where dist > planned."""
    spread = np.maximum(r["hi"] - r["lo"], 1e-30)
    return float(np.max(np.where(dist > r["planned"], (dist - r["planned"]) / spread, 0.0)))


def main(first=0, last=14):
    import torch
    from test_torch_allocator import CONFIGS

    torch.set_num_threads(1)
    for cfg in sorted(CONFIGS):
        for seed in range(first, last):
            res = leaf_spread(*CONFIGS[cfg], seed)
            row = dict(cfg=cfg, seed=seed)
            for leaf in LEAVES:
                row[f"{leaf}_single"] = excess_ratio(res[leaf]["single"], res[leaf])
                row[f"{leaf}_gap"] = excess_ratio(res[leaf]["gap"], res[leaf])
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
