"""Checks of the `p4_adam` kernel against the eager loop, shared by the card
tests (`test_torch_kernels_cuda.py`) and the CPU build of the kernel's
source (`test_torch_p4_adam.py`). Imports neither JAX nor the reference."""
import torch

#: the one-step comparison's gradient gate: the kernel's worst error against
#: the float64 eager loop, as a share of each row's largest gradient of a
#: logit, at most `P4_GRAD_FACTOR` times the float32 eager loop's own worst
#: error, or `P4_GRAD_FLOOR` (about 80 float32 ulps). Where a budget binds,
#: d/dw is a difference of near-equal terms (and d/dz likewise in the
#: softmax's backward), so each route's error there is its own rounding of
#: those terms: in a CPU build of the kernel's source (a thread a lane) the
#: two routes' worst errors differed up to 3.6 times at (N 4, K 5); a wrong
#: term would be off by a share near 1
P4_GRAD_FACTOR, P4_GRAD_FLOOR = 10.0, 1e-5
#: the 800-step comparison's gates on every row: |kernel - plain| / |plain|
#: of the final decode's P4 loss at most `P4_ROW_GAP`, and at least a share
#: `P4_SAME_X` of the rows with the same hardened X. Both routes are float32
#: runs of one annealed descent, and a rounding that tips a near tie parts
#: a row's continuous leaves: on an H100 the largest gap over 1024 Table-I
#: rows read 1.43e-2 with every hardened X the same; a row whose gradient
#: is wrong reads far above both
P4_ROW_GAP, P4_SAME_X = 5e-2, 0.99


def p4_rows(device, N, K, rows=64, pad=None, seed=0):
    """Table-I rows (padded into ``pad`` with masked devices and
    subcarriers), the full-payload start's payload and rate floor, and a
    perturbed round-robin warm start: (params, kappa1, payload, rmin, P0, X0)."""
    from repro_torch.core import pad_params, sample_params_batch
    from repro_torch.core.allocator import equal_start

    params = sample_params_batch(seed, rows, N=N, K=K, device=device)
    if pad is not None:
        params = pad_params(params, *pad)
    _, P0, X0 = equal_start(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    live = params.dev_mask[..., :, None] * params.sc_mask[..., None, :]
    X0 = (0.7 * X0 + 0.3 * torch.rand(X0.shape, generator=gen, device=device) / params.N) * live
    kappa1 = torch.linspace(0.5, 2.0, rows, device=device)
    return params, kappa1, params.D + params.C, params.C / params.t_sc_max, P0 * 1.1, X0


def run_loop(mode, kernel_route, params, kappa1, payload, rmin, logits, cfg, X=None):
    """One route of an Adam loop as a `core.pgd.AdamRun`: the kernel
    (`kernels.p4_adam.ops`, its moments asked for) or the eager loop of
    `core.pgd`, on the tensors' own device. ``mode`` "pgd" takes the logits
    (z, w, w_tot); "power" takes (w, w_tot) and the fixed ``X``."""
    from repro_torch.core import pgd
    from repro_torch.kernels.p4_adam import ops

    if mode == "pgd":
        args = (params, kappa1, payload, rmin, *logits, cfg)
        return (pgd.AdamRun(*ops.pgd_loop(*args, moments=True)) if kernel_route
                else pgd._pgd_loop(*args))
    args = (params, kappa1, payload, rmin, X, *logits, cfg.steps, cfg.lr, cfg.penalty_rate)
    return pgd.AdamRun(*ops.power_loop(*args, moments=True)) if kernel_route else pgd._power_loop(*args)


def one_step_check(device, shape, pad, mode, rows=64):
    """One Adam step on ``rows`` rows, kernel against the eager loop on the
    same tensors and against the eager loop in float64. The gradient (the
    first moment over 0.1) passes the gate of `P4_GRAD_FACTOR` and
    `P4_GRAD_FLOOR`. The second moment is 0.001 g^2 of the kernel's own g,
    and each new logit the Adam step of its own moments, to 4 ulps of
    |logit| + lr. Where the float64 gradient is exactly zero (padded devices
    and subcarriers, and in power mode the entries X leaves out) the
    kernel's is too, and the logit keeps its value. Every entry of every
    row is checked."""
    from repro_torch.core import pgd
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.core.types import tree_map
    from repro_torch.kernels.p4_adam import kernel as p4_kernel

    params, kappa1, payload, rmin, P0, X0 = p4_rows(device, *shape, rows=rows, pad=pad)
    cfg = PGDConfig(steps=1)
    Xb = None
    if mode == "pgd":
        logits = pgd._pgd_start(params, P0, X0)
    else:
        Xb = (X0 == X0.amax(dim=-2, keepdim=True)).float() * X0.gt(0).float()
        w = pgd._logit(P0 * Xb / torch.clamp_min(params.p_max[..., None] * Xb, pgd._EPS))
        logits = (w, pgd._logit(torch.sum(P0 * Xb, dim=-1) / params.p_max * 1.2))
    args = (params, kappa1, payload, rmin, logits)
    before = p4_kernel.launches
    got = run_loop(mode, True, *args, cfg, Xb)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    assert p4_kernel.launches == before + 1
    want = run_loop(mode, False, *args, cfg, Xb)
    exact = run_loop(mode, False, *tree_map(lambda t: t.double(), args), cfg,
                     None if Xb is None else Xb.double())
    bc1, bc2 = (float(x) for x in p4_kernel.schedule(1, cfg.temp_end, device)[0, 1:])
    for name, x0, xk, (mk, vk), (mp, _), (m64, _) in zip(
            ("z", "w", "w_tot")[-len(logits):], logits, got.logits, got.moments, want.moments,
            exact.moments):
        g_k, g_p, g64 = mk.double() / 0.1, mp.double() / 0.1, m64 / 0.1
        scale = g64.abs().flatten(1).amax(dim=1).reshape((-1,) + (1,) * (g64.ndim - 1))
        scale = torch.clamp_min(scale, 1e-300)
        err_k, err_p = (((g - g64).abs() / scale).max() for g in (g_k, g_p))
        assert float(err_k) <= max(P4_GRAD_FACTOR * float(err_p), P4_GRAD_FLOOR), (
            name, float(err_k), float(err_p))
        eps32 = torch.finfo(torch.float32).eps
        v_want = 0.001 * g_k**2
        assert bool(((vk.double() - v_want).abs() <= 8 * eps32 * v_want + 1e-45).all()), name
        step = (-cfg.lr * (mk.double() / bc1)) / (torch.sqrt(vk.double() / bc2) + 1e-8)
        err = (xk.double() - (x0.double() + step)).abs()
        assert bool((err <= 4 * eps32 * (x0.double().abs() + cfg.lr)).all()), (name, float(err.max()))
        unmoved = m64 == 0                     # nothing real feeds the entry
        assert torch.equal(xk[unmoved], x0[unmoved]) and torch.all(mk[unmoved] == 0), name
    if pad is not None:
        pad_dev = params.dev_mask == 0
        assert torch.equal(got.P[pad_dev], torch.zeros_like(got.P[pad_dev]))


def loss_gaps(device, N, K, rows, pad=None, seed=7, steps=800):
    """``steps`` PGD steps (the default config's otherwise) from the
    full-payload start, kernel against the eager loop on the same tensors:
    each row's (kernel - plain) / |plain| of the final decode's P4 loss,
    whether the kernel's losses are all finite, and the share of rows whose
    hardened X is the same."""
    from repro_torch.core import pgd
    from repro_torch.core.allocator import harden_x
    from repro_torch.core.pgd import PGDConfig

    params, kappa1, payload, rmin, P0, X0 = p4_rows(device, N, K, rows=rows, pad=pad, seed=seed)
    cfg = PGDConfig(steps=steps)
    logits = pgd._pgd_start(params, P0, X0)
    runs = [run_loop("pgd", route, params, kappa1, payload, rmin, logits, cfg)
            for route in (True, False)]
    loss_k, loss_p = (p4_loss(params, kappa1, payload, rmin, r.P, r.X, cfg) for r in runs)
    hard = [harden_x(r.X, params.N, params.K, params.dev_mask, params.sc_mask) for r in runs]
    same = float(torch.all((hard[0] == hard[1]).flatten(1), dim=1).float().mean())
    return (loss_k - loss_p) / loss_p.abs(), bool(torch.isfinite(loss_k).all()), same


def p4_loss(params, kappa1, payload, rmin, P, X, cfg):
    """The P4 loss of a decode (`core.pgd.solve_p4_pgd`'s), per row."""
    from repro_torch.core.system import device_rate

    r = device_rate(params, P, X)
    frac = torch.sum(P, dim=-1) * payload / torch.clamp_min(r, 1e-12)
    hinge = torch.square(torch.clamp_min(rmin - r, 0.0) / torch.clamp_min(rmin, 1.0))
    return (kappa1 * torch.sum(frac, dim=-1) + cfg.penalty_rate * torch.sum(hinge, dim=-1)
            + cfg.penalty_binary * torch.sum(X * (1.0 - X), dim=(-2, -1)))
