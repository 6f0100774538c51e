"""Build, bind and launch the CUDA selective-scan kernel.

``csrc/mamba_scan.cu`` (its header says what it replaces, what bounds it and
how it is laid out) is built and loaded by `repro_torch.kernels.build` at
first use. Nothing is built when this module is imported.

This module only builds, binds and launches: `mamba_scan` takes CUDA tensors
and raises on anything else or on a failed launch. It launches with the
inputs' card current (`torch.cuda.device`), on that card's current stream.
Which inputs reach it is `ops.py`'s choice. `launches` counts the kernel's
launches (set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ..build import BASE_FLAGS, CudaLibrary, aligned16, refuse_autograd

#: kernel launches since the counter was last set to 0
launches = 0

SOURCE = pathlib.Path(__file__).resolve().with_name("csrc") / "mamba_scan.cu"
NVCC_FLAGS = BASE_FLAGS
#: state sizes N the kernel is instantiated for
STATE_SIZES = (8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.mamba_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 8
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


_LIB = CudaLibrary("mamba_scan", SOURCE, NVCC_FLAGS, _bind)
#: compile ``csrc/mamba_scan.cu`` if needed; return (library, ptxas log)
build = _LIB.build
#: the bound library, built at first use
load = _LIB.load


def mamba_scan(x, dt, Bm, Cm, A, D) -> torch.Tensor:
    """The selective scan of x, dt (B, S, di) with Bm, Cm (B, S, N), A
    (di, N) and D (di,), from the zero state; returns y (B, S, di), contiguous,
    in x's type.

    x, dt, and Bm/Cm (one type for both): CUDA tensors, float32 or bfloat16
    each, all on one card, any strides with the last dim contiguous, N in
    `STATE_SIZES`. A and D: any floating type on the same card (taken as
    float32). The math is float32 whatever the types. Forward only: an input
    that requires grad under grad mode raises (`refuse_autograd`).
    """
    refuse_autograd("mamba_scan", x, dt, Bm, Cm, A, D)
    ts = (x, dt, Bm, Cm, A, D)
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(
            "mamba_scan kernel: x, dt, Bm, Cm, A, D must be on one CUDA device, got "
            + ", ".join(str(t.device) for t in ts)
        )
    if Cm.dtype != Bm.dtype:
        raise ValueError(f"mamba_scan kernel: Bm ({Bm.dtype}) and Cm ({Cm.dtype}) differ in type")
    for name, dtype in (("x", x.dtype), ("dt", dt.dtype), ("Bm", Bm.dtype)):
        if dtype not in _DTYPES:
            raise ValueError(f"mamba_scan kernel: {name} ({dtype}) must be float32 or bfloat16")
    if x.ndim != 3 or dt.shape != x.shape:
        raise ValueError(
            f"mamba_scan kernel: want x and dt of one shape (B, S, di), got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}"
        )
    B, S, di = x.shape
    N = Bm.shape[-1] if Bm.ndim == 3 else -1
    if Bm.ndim != 3 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(
            f"mamba_scan kernel: want Bm and Cm of shape (B, S, N) = ({B}, {S}, N), got "
            f"{tuple(Bm.shape)}, {tuple(Cm.shape)}"
        )
    if tuple(A.shape) != (di, N) or tuple(D.shape) != (di,):
        raise ValueError(
            f"mamba_scan kernel: A is {tuple(A.shape)}, D {tuple(D.shape)}; want "
            f"(di, N) = {(di, N)} and (di,)"
        )
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan kernel: state size {N} not in {STATE_SIZES}")
    if B > 65535:
        raise ValueError(f"mamba_scan kernel: B={B} > 65535")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"mamba_scan kernel: {name}'s last dim is not contiguous")
    y = torch.empty((B, S, di), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    Af, Df = A.float().contiguous(), D.float().contiguous()
    global launches
    lib = load()
    with torch.cuda.device(x.device):
        err = lib.mamba_scan_fwd(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), Af.data_ptr(),
            Df.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], _DTYPES[dt.dtype], _DTYPES[Bm.dtype], B, S, di, N,
            int(aligned16(x) and aligned16(dt)),
            *(s for t in (x, dt, Bm, Cm) for s in t.stride()[:2]),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mamba_scan_fwd launch failed: CUDA error {err}")
    launches += 1
    return y
