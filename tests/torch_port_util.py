"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`).

Inputs are numpy arrays; the JAX reference's pytrees are converted here, on
the test side, and handed to the port through `repro_torch.bridge`.
"""
import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core.types import META_FIELDS, PARAM_FIELDS


def jax_params_to_numpy(p):
    """(arrays, meta) of a reference `SystemParams` (batched or not)."""
    arrays = {k: np.asarray(getattr(p, k)) for k in PARAM_FIELDS}
    meta = {k: getattr(p, k) for k in META_FIELDS}
    return arrays, meta


def to_port_params(p):
    """A reference `SystemParams` as the port's, on the CPU."""
    return bridge.params_from_numpy(*jax_params_to_numpy(p), device="cpu")


def to_port_alloc(a):
    """A reference `Allocation` as the port's, on the CPU."""
    return bridge.allocation_from_numpy(
        {k: np.asarray(getattr(a, k)) for k in ("f", "P", "X", "rho")}, device="cpu"
    )


def port_weights(k1=1.0, k2=1.0, k3=1.0):
    return bridge.weights_from_numpy({"kappa1": k1, "kappa2": k2, "kappa3": k3}, device="cpu")


def np_(x):
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def numpy_scenarios(seed, N=4, K=12, batch=None, B=20e6):
    """Scenarios of the paper's Table-I law (`scenarios/iid_rayleigh.py`)
    drawn with numpy: (arrays, meta), with a leading ``batch`` axis if given.
    """
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    f32 = lambda x: np.asarray(x, np.float32)
    u = rng.uniform(1e-3, 1.0, lead + (N,))
    pl_db = 128.1 + 37.6 * np.log10(np.sqrt(u) * 500.0 / 1000.0)
    shadow = 8.0 * rng.standard_normal(lead + (N,))
    ray = rng.exponential(1.0, lead + (N, K))
    ones = np.ones(lead + (N,), np.float32)
    arrays = dict(
        g=f32(10.0 ** (-(pl_db + shadow)[..., None] / 10.0) * ray),
        c=f32(rng.uniform(1e4, 3e4, lead + (N,))),
        d=500.0 * ones, D=2.81e4 * ones, C=4.15e7 * ones, p_max=0.1 * ones,
        f_max=2e9 * ones, t_sc_max=20.0 * ones,
        dev_mask=ones, sc_mask=np.ones(lead + (K,), np.float32),
    )
    meta = dict(N=N, K=K, B=B, N0=10.0 ** ((-174.0 - 30.0) / 10.0), xi=1e-28, eta=10, q=2)
    return arrays, meta


def both_params(arrays, meta):
    """The same scenario(s) as the reference's and the port's `SystemParams`."""
    import jax.numpy as jnp
    from repro.core import SystemParams as JSystemParams

    jp = JSystemParams(**{k: jnp.asarray(v) for k, v in arrays.items()}, **meta)
    return jp, bridge.params_from_numpy(arrays, meta, device="cpu")


#: the reference's kernel-vs-oracle tolerance (tests/test_kernels.py:256)
RTOL, ATOL = 5e-7, 1e-5


def grid_inputs(seed, B, G, N, masked_rows=True):
    """Random (B, G, N) candidate grids + per-scenario parameter rows, the
    ranges of tests/test_kernels.py:_batch_grid_inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    u = lambda shape, lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)
    f = u((B, G, N), 1e8, 2e9)
    p = u((B, G, N), 1e-3, 0.1)
    r = u((B, G, N), 1e5, 3e7)
    rho = u((B, G), 0.05, 1.0)
    c = u((B, N), 1e3, 1e4)
    d = u((B, N), 1e5, 1e6)
    D = u((B, N), 1e5, 1e6)
    C = u((B, N), 1e5, 1e6)
    tsc = np.full((B, N), 0.5, np.float32)
    fmax = np.full((B, N), 2e9, np.float32)
    if masked_rows:
        mask = (rng.uniform(size=(B, N)) > 0.4).astype(np.float32)
        mask[:, 0] = 1.0                     # >= 1 real device per scenario
    else:
        mask = np.ones((B, N), np.float32)
    return (f, p, r, rho, c, d, D, C, tsc, fmax), mask


def assert_scores(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=ATOL)


def tf32(x):
    """``cvt.rna.tf32.f32`` in plain PyTorch: float32 x rounded to 10
    mantissa bits, ties away from zero, by integer ops on its bits (the low
    13 zero), as the float32 flash kernel splits its operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)
