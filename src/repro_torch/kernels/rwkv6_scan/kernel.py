"""Build, bind and launch the CUDA WKV6 kernel.

``csrc/rwkv6_scan.cu`` (its header says what it replaces, what bounds it and
how it is laid out) is built and loaded by `repro_torch.kernels.build` at
first use. Nothing is built when this module is imported.

This module only builds, binds and launches: `rwkv6_scan` takes CUDA tensors
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

#: kernel launches since the counter was last set to 0; `repro_torch.spans`
#: records its change over each span, so a launch made without this
#: wrapper (a CUDA graph's replay) adds the launches it holds here
launches = 0

SOURCE = pathlib.Path(__file__).resolve().with_name("csrc") / "rwkv6_scan.cu"
NVCC_FLAGS = BASE_FLAGS
#: head dims the kernel is instantiated for
HEAD_DIMS = (32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 8
        + [ctypes.c_longlong] * 15
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


_LIB = CudaLibrary("rwkv6_scan", SOURCE, NVCC_FLAGS, _bind)
#: compile ``csrc/rwkv6_scan.cu`` if needed; return (library, ptxas log)
build = _LIB.build
#: the bound library, built at first use
load = _LIB.load


def rwkv6_scan(r, k, v, w, u, out_dtype=None) -> torch.Tensor:
    """WKV6 of r/k/v/w (B, H, S, hd) with the bonus u (H, hd), from the zero
    state; returns y (B, H, S, hd) in ``out_dtype`` (r's type if None) and,
    where r is dense, r's memory layout.

    r, k and v: CUDA tensors of one type, float32 or bfloat16; w: float32 or
    bfloat16; ``out_dtype``: float32 or bfloat16. All on one card, any
    strides with the head dim contiguous, hd in `HEAD_DIMS`. u: any floating
    type on the same card (taken as float32). The math is float32 whatever
    the types. Forward only: an input that requires grad under grad mode
    raises (`refuse_autograd`).
    """
    refuse_autograd("rwkv6_scan", r, k, v, w, u)
    ts = (r, k, v, w, u)
    if not all(t.is_cuda and t.device == r.device for t in ts):
        raise ValueError(
            "rwkv6_scan kernel: r, k, v, w, u must be on one CUDA device, got "
            + ", ".join(str(t.device) for t in ts)
        )
    out_dtype = r.dtype if out_dtype is None else out_dtype
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v)):
        raise ValueError(
            "rwkv6_scan kernel: r, k, v must all be float32 or all bfloat16, got "
            + ", ".join(str(t.dtype) for t in (r, k, v))
        )
    if w.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(
            f"rwkv6_scan kernel: w ({w.dtype}) and y ({out_dtype}) must be float32 or bfloat16"
        )
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(
            "rwkv6_scan kernel: want r, k, v, w of one shape (B, H, S, hd), got "
            + ", ".join(str(tuple(t.shape)) for t in (r, k, v, w))
        )
    B, H, S, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_scan kernel: u is {tuple(u.shape)}, want (H, hd) = {(H, hd)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel: head dim {hd} not in {HEAD_DIMS}")
    if H > 65535 or B > 65535:
        raise ValueError(f"rwkv6_scan kernel: H={H} or B={B} > 65535")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_scan kernel: {name}'s head dim is not contiguous")
    y = torch.empty_like(r, dtype=out_dtype)   # r's strides where r is dense, else contiguous
    if y.numel() == 0:
        return y
    uf = u.float().contiguous()
    global launches
    lib = load()
    with torch.cuda.device(r.device):
        err = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), uf.data_ptr(), y.data_ptr(),
            _DTYPES[r.dtype], _DTYPES[w.dtype], _DTYPES[out_dtype], B, H, S, hd,
            int(all(aligned16(t) for t in (r, k, v, w))),
            *(s for t in (r, k, v, w, y) for s in t.stride()[:3]),
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan_fwd launch failed: CUDA error {err}")
    launches += 1
    return y
