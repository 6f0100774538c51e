"""Parity of the port's FedSem objective grid (`repro_torch.kernels.
fedsem_objective`) with the JAX reference, on the CPU.

The same numpy inputs go through the port's plain version, the reference's
jnp oracle and the reference's Pallas kernel in interpret mode. The
infeasibility (+inf) mask must agree exactly; finite scores to rtol 5e-7,
atol 1e-5, the reference's own kernel-vs-oracle tolerance
(tests/test_kernels.py). The CUDA kernel itself is tested on the card
(tests/test_torch_kernels_cuda.py, marker ``cuda``) and by `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedsem_objective import ops as jops
from repro.kernels.fedsem_objective import ref as jref
from repro_torch.kernels.fedsem_objective import kernel, ops, ref
from torch_port_util import assert_scores as _assert_scores
from torch_port_util import grid_inputs as _batch_grid_inputs

torch.set_num_threads(1)

XI, ETA, AB = 1e-28, 10, (0.6356, 0.4025)


BATCH_CASES = [(3, 700, 4), (1, 6, 5), (8, 1, 6), (16, 3, 10)]


@pytest.mark.parametrize("B,G,N", BATCH_CASES)
@pytest.mark.parametrize("feasible_mask", [True, False], ids=["feas", "raw"])
@pytest.mark.parametrize("against", ["jnp", "pallas"])
def test_batch_grid_matches_reference(B, G, N, feasible_mask, against):
    """Port plain version == reference oracle and Pallas kernel (interpret),
    with per-row masks and per-row runtime weights."""
    args, mask = _batch_grid_inputs(11, B, G, N)
    kap = (np.linspace(0.5, 2.0, B, dtype=np.float32), np.ones((B,), np.float32),
           np.full((B,), 1.3, np.float32))
    kw = dict(xi=XI, eta=ETA, accuracy_ab=AB, check_feasible=feasible_mask)
    got = ops.objective_grid_batch(
        *(torch.from_numpy(a) for a in args), *(torch.from_numpy(k) for k in kap),
        dev_mask=torch.from_numpy(mask), **kw,
    )
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(k) for k in kap]
    if against == "jnp":
        want = jax.jit(
            lambda *a: jref.objective_grid_batch(*a[:-1], dev_mask=a[-1], **kw)
        )(*jargs, jnp.asarray(mask))
    else:
        want = jops.objective_grid_batch(
            *jargs, dev_mask=jnp.asarray(mask), use_pallas=True, interpret=True, **kw
        )
    _assert_scores(got.numpy(), want)


@pytest.mark.parametrize("G,N", [(512, 4), (1024, 10), (700, 6)])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("against", ["jnp", "pallas"])
def test_grid_matches_reference(G, N, masked, against):
    """One-scenario `objective_grid` (feasibility on, python-float weights)."""
    (f, p, r, rho, c, d, D, C, tsc, fmax), _ = _batch_grid_inputs(7, 1, G, N)
    f, p, r, rho = f[0], p[0], r[0], rho[0]
    c, d, D, C, tsc, fmax = (x[0] for x in (c, d, D, C, tsc, fmax))
    mask = np.asarray([1.0] * (N - N // 2) + [0.0] * (N // 2), np.float32) if masked else None
    args = (f, p, r, rho, c, d, D, C, tsc, fmax)
    scal = (XI, ETA, 1.0, 1.0, 1.0)
    got = ops.objective_grid(
        *(torch.from_numpy(a) for a in args), *scal,
        dev_mask=None if mask is None else torch.from_numpy(mask),
    )
    jargs = [jnp.asarray(a) for a in args]
    jmask = None if mask is None else jnp.asarray(mask)
    if against == "jnp":
        want = jax.jit(lambda *a: jref.objective_grid(*a, *scal, dev_mask=jmask))(*jargs)
    else:
        want = jops.objective_grid(
            *jargs, *scal, dev_mask=jmask, use_pallas=True, interpret=True
        )
    _assert_scores(got.numpy(), want)


def test_batch_ref_equals_per_scenario_ref():
    """The batched plain version is exactly B stacked one-scenario calls."""
    B, G, N = 4, 33, 5
    args, mask = _batch_grid_inputs(12, B, G, N)
    f, p, r, rho, c, d, D, C, tsc, fmax = (torch.from_numpy(a) for a in args)
    mask = torch.from_numpy(mask)
    kap = torch.linspace(0.7, 1.4, B)
    batch = ref.objective_grid_batch(
        f, p, r, rho, c, d, D, C, tsc, fmax, kap, 1.0, 1.0,
        xi=XI, eta=ETA, dev_mask=mask,
    )
    for b in range(B):
        one = ref.objective_grid(
            f[b], p[b], r[b], rho[b], c[b], d[b], D[b], C[b], tsc[b], fmax[b],
            XI, ETA, float(kap[b]), 1.0, 1.0, dev_mask=mask[b],
        )
        torch.testing.assert_close(batch[b], one, rtol=0, atol=0)


def test_cpu_tensors_take_plain_version_and_never_launch():
    """On CPU tensors the dispatch (`ops`) uses the plain version and the
    launch counter stays 0; asking for the kernel, through `ops` or the
    kernel's own wrapper, raises."""
    args, mask = _batch_grid_inputs(13, 2, 5, 4)
    t = [torch.from_numpy(a) for a in args]
    before = kernel.launches
    want = ref.objective_grid_batch(*t, 1.0, 1.0, 1.0, xi=XI, eta=ETA)
    got = ops.objective_grid_batch(*t, 1.0, 1.0, 1.0, xi=XI, eta=ETA)
    one = ops.objective_grid(*(x[0] for x in t), XI, ETA, 1.0, 1.0, 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        one, ref.objective_grid(*(x[0] for x in t), XI, ETA, 1.0, 1.0, 1.0), rtol=0, atol=0)
    assert kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.objective_grid_batch(*t, 1.0, 1.0, 1.0, xi=XI, eta=ETA, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.objective_batch(*t, None, 1.0, 1.0, 1.0, *AB, xi=XI, eta=ETA)
    assert kernel.launches == before


def test_kernel_source_and_flags():
    """The kernel is CUDA C++ for sm_90a with the numerics the plain version
    needs: no fused multiply-add, precise expf/logf."""
    src = kernel.SOURCE.read_text()
    assert 'extern "C" int fedsem_objective_batch' in src
    assert "--use_fast_math" not in kernel.NVCC_FLAGS
    assert "-fmad=false" in kernel.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernel.NVCC_FLAGS
