"""Build, bind and launch the CUDA kernel for the FedSem objective (eq. 13).

``csrc/objective.cu`` (its header says what it replaces, what bounds it and
how it is laid out) is built and loaded by `repro_torch.kernels.build` at
first use. Nothing is built when this module is imported.

This module only builds, binds and launches: `objective_batch` takes CUDA
tensors and raises on anything else or on a failed launch. It launches with
the inputs' card current (`torch.cuda.device`), on that card's current
stream. Which inputs reach it is `ops.py`'s choice. `prepare` + `launch` are
its two halves (checks, then the launch alone), for callers that launch the
same arguments repeatedly, such as a timing loop. `launches` counts the
kernel's launches (set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import torch

from ..build import BASE_FLAGS, CudaLibrary, refuse_autograd

#: kernel launches since the counter was last set to 0; `repro_torch.spans`
#: records its change over each span, so a launch made without this
#: wrapper (a CUDA graph's replay) adds the launches it holds here
launches = 0

SOURCE = pathlib.Path(__file__).resolve().with_name("csrc") / "objective.cu"
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)
# dynamic shared memory of a block: six (N,) rows, within the 48 KB default
_MAX_N = 48 * 1024 // (6 * 4)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fedsem_objective_batch
    fn.argtypes = (
        [ctypes.c_void_p] * 17
        + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


_LIB = CudaLibrary("fedsem_objective", SOURCE, NVCC_FLAGS, _bind)
#: compile ``csrc/objective.cu`` if needed; return (library, ptxas log)
build = _LIB.build
#: the bound library, built at first use
load = _LIB.load


class Launch(NamedTuple):
    """A validated launch of the kernel: contiguous float32 inputs on one
    card, the output buffer, and the scalar arguments."""

    ins: tuple
    out: torch.Tensor
    B: int
    G: int
    N: int
    eta: float
    xi_eta: float
    check_feasible: int


def prepare(
    f, p, r, rho,
    c, d, D, C, t_sc_max, f_max,
    dev_mask,
    kappa1, kappa2, kappa3, a_acc, b_acc,
    *,
    xi: float, eta: float,
    check_feasible: bool = True,
) -> Launch:
    """Check and lay out the arguments of a launch on CUDA tensors (shapes as
    in `objective_batch`); raise on what the kernel does not take, and on an
    input that requires grad under grad mode (`refuse_autograd`: the kernel
    is forward only)."""
    refuse_autograd("fedsem_objective", f, p, r, rho, c, d, D, C, t_sc_max, f_max, dev_mask,
                    kappa1, kappa2, kappa3, a_acc, b_acc)
    f = torch.as_tensor(f)
    if not f.is_cuda:
        raise ValueError(f"fedsem_objective kernel: tensors must be on a CUDA device, got {f.device}")
    B, G, N = f.shape
    dev = f.device
    if dev_mask is None:
        dev_mask = torch.ones((B, N), dtype=torch.float32, device=dev)
    if N > _MAX_N or B > 65535:
        raise ValueError(f"objective_batch: N={N} > {_MAX_N} or B={B} > 65535")

    def arg(x, shape, name):
        t = torch.as_tensor(x)
        if t.device.type == "cpu" and t.ndim == 0:
            t = t.to(dev)  # a python float or 0-dim weight
        if t.device != dev:
            raise ValueError(f"objective_batch: {name} is on {t.device}, f on {dev}")
        t = t.to(torch.float32)
        if len(shape) == 1:
            t = t.reshape(-1).expand(shape)
        if tuple(t.shape) != shape:
            raise ValueError(f"objective_batch: {name} has shape {tuple(t.shape)}, want {shape}")
        return t.contiguous()

    cand = (B, G, N)
    ins = (
        arg(f, cand, "f"), arg(p, cand, "p"), arg(r, cand, "r"),
        arg(rho, (B, G), "rho"),
        *(arg(x, (B, N), n) for x, n in zip(
            (c, d, D, C, t_sc_max, f_max, dev_mask),
            ("c", "d", "D", "C", "t_sc_max", "f_max", "dev_mask"),
        )),
        *(arg(x, (B,), n) for x, n in zip(
            (kappa1, kappa2, kappa3, a_acc, b_acc),
            ("kappa1", "kappa2", "kappa3", "a_acc", "b_acc"),
        )),
    )
    out = torch.empty((B, G), dtype=torch.float32, device=dev)
    # xi * eta is rounded once, as the plain version rounds the python product
    return Launch(ins, out, B, G, N, float(eta), float(xi) * float(eta),
                  int(bool(check_feasible)))


def launch(args: Launch) -> torch.Tensor:
    """Launch the kernel on the current stream; raise if the launch fails."""
    global launches
    if args.B == 0 or args.G == 0:
        return args.out
    lib = load()
    with torch.cuda.device(args.out.device):
        err = lib.fedsem_objective_batch(
            *(t.data_ptr() for t in args.ins), args.out.data_ptr(),
            args.B, args.G, args.N, args.eta, args.xi_eta, args.check_feasible,
            torch.cuda.current_stream(args.out.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fedsem_objective_batch launch failed: CUDA error {err}")
    launches += 1
    return args.out


def objective_batch(
    f, p, r, rho,
    c, d, D, C, t_sc_max, f_max,
    dev_mask,
    kappa1, kappa2, kappa3, a_acc, b_acc,
    *,
    xi: float, eta: float,
    check_feasible: bool = True,
) -> torch.Tensor:
    """Objective (eq. 13) for B scenarios x G candidates -> (B, G).

    f/p/r (B, G, N), rho (B, G), parameter rows and ``dev_mask`` (B, N);
    weights and accuracy coefficients are python floats, scalars or (B,).
    The tensors must lie on one CUDA device.
    """
    return launch(prepare(
        f, p, r, rho, c, d, D, C, t_sc_max, f_max, dev_mask,
        kappa1, kappa2, kappa3, a_acc, b_acc,
        xi=xi, eta=eta, check_feasible=check_feasible,
    ))


def objective_grid(
    f, p, r, rho,
    c, d, D, C, t_sc_max, f_max,
    dev_mask,
    *, xi: float, eta: float, k1: float, k2: float, k3: float,
    a_acc: float, b_acc: float,
) -> torch.Tensor:
    """One scenario, G candidates, feasibility on: the kernel at B = 1.

    f/p/r (G, N), rho (G,), parameter rows (N,) -> (G,).
    """
    f = torch.as_tensor(f)
    if dev_mask is None:
        dev_mask = torch.ones((f.shape[-1],), dtype=torch.float32, device=f.device)

    def one(x):
        return torch.as_tensor(x, device=f.device)[None]

    return objective_batch(
        f[None], one(p), one(r), one(rho),
        one(c), one(d), one(D), one(C), one(t_sc_max), one(f_max), one(dev_mask),
        k1, k2, k3, a_acc, b_acc,
        xi=xi, eta=eta, check_feasible=True,
    )[0]
