"""The `p4_adam` module on the CPU: dispatch, the kernel's gradient, and
the kernel's source built for the CPU.

CPU tensors take the eager autograd loops of `core.pgd` and launch nothing.
The CUDA kernel writes the loss's gradient out by hand; `_written_out` below
is that arithmetic in torch, line for line with `csrc/p4_adam.cu` (the
decode, the three sums over subcarriers, each device's scalar work, the
backward to w, X and z), and it is held to autograd's gradient of the plain
loss in float64, masked devices and padded subcarriers included.

The source itself is also built with g++ against `tests/cpu_cuda/`, a
stand-in for the CUDA runtime that runs each CUDA thread as a std::thread
(shuffles and __syncthreads are barriers), and held to the eager loop by the
card tests' own checks (`p4_adam_checks`): its indexing, its sums over
lanes and warps, its padding and both modes, at CPU float32. Timing and the
card's own arithmetic come only from the card (`test_torch_kernels_cuda.py`).
"""
import contextlib
import ctypes
import pathlib
import shutil
import subprocess
import types

import pytest
import torch

import p4_adam_checks

from repro_torch import spans
from repro_torch.core import pad_params, sample_params_batch
from repro_torch.core import pgd
from repro_torch.core.pgd import PGDConfig, power_given_x, solve_p4_pgd
from repro_torch.core.types import tree_map
from repro_torch.kernels.p4_adam import kernel, ops

LN2 = 0.6931471805599453


def _d_max(x, c):
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0)).to(x.dtype)


def _d_min(x, c):
    return torch.where(x < c, 1.0, torch.where(x == c, 0.5, 0.0)).to(x.dtype)


def _written_out(params, kappa1, payload, rmin, w, w_tot, *, z=None, X=None, temp=1.0,
                 penalty_rate=10.0, penalty_binary=0.3):
    """The kernel's hand-written gradient of the P4 loss: (gz, gw, gw_tot) in
    PGD mode (``z`` given), (gw, gw_tot) in power mode (``X`` given)."""
    pm = params.p_max[..., None]
    on = params.dev_mask[..., :, None] > 0
    q = params.q
    if z is not None:                                      # softmax over N+1, padded devices out
        u = z / temp
        dev_u = torch.where(on, u[..., :-1, :], -torch.inf)
        mx = torch.maximum(torch.amax(dev_u, dim=-2), u[..., -1, :])[..., None, :]
        e = torch.cat([torch.where(on, torch.exp(u[..., :-1, :] - mx), 0.0),
                       torch.exp(u[..., -1:, :] - mx)], dim=-2)
        x = e / torch.sum(e, dim=-2, keepdim=True)
        X = x[..., :-1, :] * params.sc_mask[..., None, :]
        xq, dxq = X**q, q * X ** (q - 1)
    else:
        xq = X
    s = torch.sigmoid(w)
    P_raw = pm * xq * s
    S = torch.sum(P_raw, dim=-1)                           # first sum
    st = torch.sigmoid(w_tot)
    budget = params.p_max * st
    tot = torch.clamp_min(S, 1e-12)
    ratio = budget / tot
    c = torch.clamp_max(ratio, 1.0)
    P = P_raw * c[..., None]
    snr = P * params.g / params.noise_sc
    rsc = params.bbar * torch.log1p(snr) / LN2
    r = torch.sum(X * rsc, dim=-1)                         # second sum
    Psum = c * S
    rc = torch.clamp_min(r, 1e-12)
    kap = torch.as_tensor(kappa1, dtype=w.dtype)[..., None]
    gPs = kap / rc * payload
    gr = -(kap * Psum * payload) / (rc * rc) * _d_max(r, 1e-12)
    dm = rmin - r
    rmc = torch.clamp_min(rmin, 1.0)
    h = torch.clamp_min(dm, 0.0) / rmc
    gr = gr - penalty_rate * 2.0 * h / rmc * _d_max(dm, 0.0)
    gX_r = gr[..., None] * rsc
    gsnr = gr[..., None] * X * params.bbar / LN2 / (1.0 + snr)
    gP = gsnr * params.g / params.noise_sc + gPs[..., None]
    gc = torch.sum(gP * P_raw, dim=-1)                     # third sum
    gratio = gc * _d_min(ratio, 1.0)
    gS = -(gratio * budget) / (tot * tot) * _d_max(S, 1e-12)
    gwt = gratio / tot * params.p_max * st * (1.0 - st)
    gPr = gP * c[..., None] + gS[..., None]
    gw = gPr * pm * xq * s * (1.0 - s)
    if z is None:
        return gw, gwt
    gX = gX_r + gPr * s * pm * dxq + penalty_binary * (1.0 - 2.0 * X)
    gx = torch.cat([gX * params.sc_mask[..., None, :], torch.zeros_like(x[..., -1:, :])], dim=-2)
    dot = torch.sum(x * gx, dim=-2, keepdim=True)
    gz = x * (gx - dot) / temp
    gz = torch.cat([torch.where(on, gz[..., :-1, :], 0.0), gz[..., -1:, :]], dim=-2)
    return gz, gw, gwt


def _problem(padded: bool, seed: int = 3):
    """Table-I rows in float64 with the solver's start and a rate floor that
    binds for some devices: (params, kappa1, payload, rmin, P0, X0)."""
    params = sample_params_batch(seed, 4, N=6, K=12, device="cpu")
    if padded:                                              # masked devices and subcarriers
        params = pad_params(params, 8, 16)
    params = tree_map(lambda t: t.double(), params)
    gen = torch.Generator().manual_seed(seed)
    shape = params.g.shape
    X0 = torch.rand(shape, generator=gen, dtype=torch.float64) * params.sc_mask[..., None, :]
    X0 = X0 * params.dev_mask[..., :, None] / params.N
    P0 = params.p_max[..., None] * X0 * 0.3
    payload = (params.D + 0.5 * params.C) * params.dev_mask
    rmin = torch.rand(shape[:-1], generator=gen, dtype=torch.float64) * 2e6 * params.dev_mask
    kappa1 = torch.linspace(0.5, 2.0, shape[0], dtype=torch.float64)
    return params, kappa1, payload, rmin, P0, X0


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
@pytest.mark.parametrize("temp", [1.0, 0.4])
def test_written_out_gradient_is_autograds_in_pgd_mode(padded, temp):
    params, kappa1, payload, rmin, P0, X0 = _problem(padded)
    z, w, w_tot = pgd._pgd_start(params, P0, X0)
    cfg = PGDConfig()

    def loss(z, w, w_tot):
        P, X = pgd._decode(params, z, w, w_tot, temp)
        r = pgd.device_rate(params, P, X)
        frac = torch.sum(P, dim=-1) * payload / pgd._maximum(r, pgd._EPS)
        hinge = torch.square(pgd._maximum(rmin - r, 0.0) / pgd._maximum(rmin, 1.0))
        return (kappa1 * torch.sum(frac, dim=-1) + cfg.penalty_rate * torch.sum(hinge, dim=-1)
                + cfg.penalty_binary * torch.sum(X * (1.0 - X), dim=(-2, -1)))

    want = pgd._grad(loss, z, w, w_tot)
    got = _written_out(params, kappa1, payload, rmin, w, w_tot, z=z, temp=temp)
    for name, a, b in zip(("z", "w", "w_tot"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()), msg=name)
    if padded:                                              # exactly zero where nothing is real
        pad_dev = params.dev_mask == 0
        assert torch.all(got[0][..., :-1, :][pad_dev] == 0) and torch.all(got[1][pad_dev] == 0)
        pad_sc = (params.sc_mask == 0)[..., None, :].expand_as(got[0])
        assert torch.all(got[0][pad_sc] == 0)


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_written_out_gradient_is_autograds_in_power_mode(padded):
    params, kappa1, payload, rmin, P0, X0 = _problem(padded, seed=4)
    Xb = (X0 == X0.amax(dim=-2, keepdim=True)).double() * params.sc_mask[..., None, :]
    Xb = Xb * params.dev_mask[..., :, None]
    w = pgd._logit(P0 / torch.clamp_min(params.p_max[..., None] * Xb, pgd._EPS))
    w_tot = pgd._logit(torch.sum(P0, dim=-1) / params.p_max * 1.2)

    def loss(w, w_tot):
        P = pgd._power_decode(params, Xb, w, w_tot)
        r = pgd.device_rate(params, P, Xb)
        frac = torch.sum(P, dim=-1) * payload / pgd._maximum(r, pgd._EPS)
        hinge = torch.square(pgd._maximum(rmin - r, 0.0) / pgd._maximum(rmin, 1.0))
        return kappa1 * torch.sum(frac, dim=-1) + 10.0 * torch.sum(hinge, dim=-1)

    want = pgd._grad(loss, w, w_tot)
    got = _written_out(params, kappa1, payload, rmin, w, w_tot, X=Xb)
    for name, a, b in zip(("w", "w_tot"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()), msg=name)


def test_ties_split_the_gradient_as_the_plain_max_and_min_do():
    """`d_max` and `d_min` (the kernel's derivatives of max(x, c) and
    min(x, c)) are those autograd takes through `pgd._maximum` and
    `pgd._minimum`: 1 on the winning side, 0.5 on a tie, 0 otherwise."""
    x = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64, requires_grad=True)
    for plain, written in ((pgd._maximum, _d_max), (pgd._minimum, _d_min)):
        (got,) = torch.autograd.grad(plain(x, 1.0).sum(), x)
        assert torch.equal(got, written(x.detach(), 1.0))


@pytest.mark.parametrize("which", ["pgd", "power"])
def test_cpu_tensors_take_the_eager_loop(which):
    """On CPU tensors the solver runs `core.pgd`'s eager loop (`_pgd_loop`,
    `_power_loop`, bit for bit) and launches no kernel; the kernel route
    (`ops`) raises on them."""
    params = sample_params_batch(1, 2, N=4, K=8, device="cpu")
    X0 = torch.full(params.g.shape, 0.2)
    P0 = params.p_max[..., None] * X0 * 0.1
    payload, rmin = params.D + params.C, torch.full((2, 4), 1e4)
    cfg = PGDConfig(steps=5)
    before = kernel.launches
    if which == "pgd":
        P, X = solve_p4_pgd(params, 1.0, payload, rmin, P0, X0, cfg)
        z, w, w_tot = pgd._pgd_start(params, P0, X0)
        run = pgd._pgd_loop(params, 1.0, payload, rmin, z, w, w_tot, cfg)
        assert torch.equal(run.P, P) and torch.equal(run.X, X)
        call = lambda: ops.pgd_loop(params, 1.0, payload, rmin, z, w, w_tot, cfg)
    else:
        Xb = (X0 > 0.1).float()
        P = power_given_x(params, 1.0, payload, rmin, Xb, steps=5)
        w = pgd._logit(params.p_max[..., None] * Xb * 0.25
                       / torch.clamp_min(params.p_max[..., None] * Xb, pgd._EPS))
        w_tot = pgd._logit(torch.sum(params.p_max[..., None] * Xb * 0.25, dim=-1) / params.p_max * 1.2)
        run = pgd._power_loop(params, 1.0, payload, rmin, Xb, w, w_tot, 5, 0.08, 10.0)
        assert torch.equal(run.P, P) and run.X is Xb
        call = lambda: ops.power_loop(params, 1.0, payload, rmin, Xb, w, w_tot, 5, 0.08, 10.0)
    assert kernel.launches == before
    assert len(run.moments) == len(run.logits) and all(len(mv) == 2 for mv in run.moments)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert kernel.launches == before


def test_the_kernel_layer_does_not_import_core():
    """`core.pgd` chooses the route and imports the kernel's layout; the
    kernel module imports nothing of `core` (no cycle)."""
    import ast

    for path in kernel.SOURCE.parent.parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any("core" in n.split(".") for n in names), (path.name, names)


def test_schedule_is_the_plain_loops_float32_steps():
    """The kernel's per-step table holds the temperature and the bias
    corrections the plain loop computes from its float32 step counter: to
    one ulp here, where the CPU's vectorised pow rounds 0.9^31 one ulp away
    from its scalar pow (on the card both are one device function, and the
    card test asks for equality)."""
    cfg = PGDConfig(steps=37, temp_end=0.3)
    sched = kernel.schedule(cfg.steps, cfg.temp_end, "cpu")
    for j, i in enumerate(torch.arange(cfg.steps, dtype=torch.float32)):
        t = i + 1
        temp = 1.0 + (cfg.temp_end - 1.0) * (i / max(cfg.steps - 1, 1))
        torch.testing.assert_close(sched[j], torch.stack([temp, 1 - 0.9**t, 1 - 0.999**t]),
                                   rtol=2**-23, atol=0.0)


def test_launch_counter_is_a_span_attribute():
    assert ("p4_adam_launches", "repro_torch.kernels.p4_adam.kernel") in spans.LAUNCH_COUNTERS


# ---------------------------------------------------------------------------
# the kernel's source, built for the CPU
# ---------------------------------------------------------------------------

STAND_IN = pathlib.Path(__file__).resolve().with_name("cpu_cuda")
#: the source's launch and shared memory (in each kernel), and what stands
#: in for them
CPU_SWAPS = (
    ("kernel<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(a);",
     "emulate(kernel, static_cast<unsigned>(blocks), threads, bytes, a);"),
    ("extern __shared__ float smem[];", "float* smem = g_smem;"),
)


@pytest.fixture(scope="module")
def source_on_cpu(tmp_path_factory):
    """`csrc/p4_adam.cu` built with g++ against the stand-in runtime, bound
    as the kernel module binds its library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    src = kernel.SOURCE.read_text()
    for cuda, cpu in CPU_SWAPS:
        assert src.count(cuda) >= 1, cuda
        src = src.replace(cuda, cpu)
    out = tmp_path_factory.mktemp("p4_adam_cpu")
    (out / "p4_adam.cpp").write_text(src)
    lib = out / "libp4_adam_cpu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", f"-I{STAND_IN}", "-o", str(lib),
                    str(out / "p4_adam.cpp")], check=True, capture_output=True)
    bound = ctypes.CDLL(str(lib))
    kernel._bind(bound)
    return bound


def _host_check(name, t, shape, device):
    """The wrapper's checks but the one for a CUDA tensor."""
    if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"p4_adam kernel: {name} {t.dtype} {tuple(t.shape)}, want {shape}")
    return t.data_ptr()


@pytest.fixture
def kernel_on_cpu(source_on_cpu, monkeypatch):
    """The kernel route taken on CPU tensors, through the CPU build."""
    monkeypatch.setattr(kernel, "load", lambda: source_on_cpu)
    monkeypatch.setattr(kernel, "_check", _host_check)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


@pytest.mark.parametrize("shape,pad,rows", [
    ((10, 50), None, 64), ((4, 5), None, 64), ((16, 64), None, 64), ((6, 12), (8, 16), 64),
    ((3, 100), None, 64), ((17, 40), None, 4), ((20, 100), (32, 128), 2), ((40, 200), (64, 256), 2)],
    ids=["table1", "table2", "alg_analysis", "padded", "two_warps_a_row", "wide", "bucket_32_128",
         "bucket_64_256"])
@pytest.mark.parametrize("mode", ["pgd", "power"])
def test_kernel_source_on_the_cpu_takes_one_step_as_the_eager_loop(kernel_on_cpu, shape, pad,
                                                                   rows, mode):
    """The card tests' one-step gates, on the CPU build of the source: rows
    of more than 16 devices (the serving ladder's (32, 128) and (64, 256)
    buckets, padded) take the wide kernel, on fewer rows here, since the
    stand-in runs each of its 256 threads a block as a thread of the host."""
    p4_adam_checks.one_step_check("cpu", shape, pad, mode, rows=rows)


@pytest.mark.parametrize("N,K,rows,steps", [(10, 50, 4, 200), (17, 40, 2, 40)],
                         ids=["table1", "wide"])
def test_kernel_source_on_the_cpu_holds_the_eager_loops_loss(kernel_on_cpu, N, K, rows, steps):
    """PGD steps from the full-payload start: the final decode's P4 loss
    within 1e-3 of the eager loop's, median over the rows (the card test's
    gate, on the CPU build of the source); the wide kernel's state carried
    across steps in its buffers, on fewer steps."""
    gaps, finite, _ = p4_adam_checks.loss_gaps("cpu", N, K, rows=rows, steps=steps)
    assert finite and float(gaps.median()) <= 1e-3
