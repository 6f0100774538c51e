"""Build, bind and launch the CUDA flash-attention kernel.

``csrc/flash_attention.cu`` (its header says what it replaces, what bounds
it and how it is laid out: bfloat16 and float32, as 3xTF32, both on the
tensor cores) is built with its headers by `repro_torch.kernels.build` at
first use. Nothing is built when this module is imported.

This module only builds, binds and launches: `flash_attention` takes CUDA
tensors and raises on anything else or on a failed launch. It launches with
the inputs' card current (`torch.cuda.device`), on that card's current
stream. Which inputs reach it is `ops.py`'s choice. `launches` counts the
kernel's launches (set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from ..build import BASE_FLAGS, CudaLibrary, refuse_autograd

#: kernel launches since the counter was last set to 0; `repro_torch.spans`
#: records its change over each span, so a launch made without this
#: wrapper (a CUDA graph's replay) adds the launches it holds here
launches = 0

SOURCE = pathlib.Path(__file__).resolve().with_name("csrc") / "flash_attention.cu"
NVCC_FLAGS = BASE_FLAGS
#: head dims the kernel takes
HEAD_DIMS = (32, 64, 80, 128, 256)
#: a head dim whose instantiation works at a greater width, by type: hd 80
#: at 128 in the bf16 kernel (TMA fills the columns past 80 with zeros). The
#: float32 kernel (3xTF32: three TF32 products for each float32 one, 12 * hd
#: tensor-core operations a pair) runs hd 80 at its own width: 8-deep steps
#: of Q K^T and wgmma n80 for P V; only its TMA slabs are 96 columns wide,
#: columns 80-95 zeros that are never multiplied
PADDED = {torch.bfloat16: {80: 128}, torch.float32: {}}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instantiated_hd(hd: int, dtype: torch.dtype) -> int:
    """The width the instantiation that runs ``hd`` in ``dtype`` works at."""
    return PADDED[dtype].get(hd, hd)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


_LIB = CudaLibrary("flash_attention", SOURCE, NVCC_FLAGS, _bind)
#: compile ``csrc/flash_attention.cu`` if needed; return (library, ptxas log)
build = _LIB.build
#: the bound library, built at first use
load = _LIB.load


def scale_of(hd: int) -> float:
    """1/sqrt(hd) rounded to float32, as the plain version computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    cap: float | None = None) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over k/v (B, S, KV, hd) -> (B, S, H, hd).

    Float32 or bfloat16 CUDA tensors of one type on one card, the head dim
    contiguous, hd in `HEAD_DIMS` (bf16's 80 at a greater width, `PADDED`), H
    a multiple of KV. Both types go to tensor-core kernels (float32 as
    3xTF32) whose TMA loads want each of q, k, v to start on 16 bytes and its
    (batch, seq, head) strides to be multiples of 16 bytes (8 bf16 or 4
    float32 elements), and at most 65535 blocks of query rows (the launcher,
    which knows a block's rows, refuses more); anything else raises (nothing
    falls back to another kernel or to the plain version). Keys at positions
    > the query's are masked if ``causal``, and at qpos - kpos >= ``window``
    if a window is given; ``cap`` is the softcap of the scores. Forward only:
    an input that requires grad under grad mode raises (`refuse_autograd`).
    """
    refuse_autograd("flash_attention", q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention kernel: q, k, v must be on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel: q, k, v must all be float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention kernel: want q (B, S, H, hd), k = v (B, S, KV, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(
            f"flash_attention kernel: k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "(same B, S, hd; H a multiple of KV)"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {hd} not in {HEAD_DIMS}")
    if H > 65535 or B > 65535:
        raise ValueError(f"flash_attention kernel: H={H} or B={B} > 65535")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention kernel: window must be positive, got {window}")
    if cap is not None and cap <= 0:
        raise ValueError(f"flash_attention kernel: cap must be positive, got {cap}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s head dim is not contiguous")
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or any(x % per16 for x in t.stride()[:3]):
            kind = "bf16" if q.dtype == torch.bfloat16 else "float32"
            raise ValueError(
                f"flash_attention kernel: {kind} {name} must start on 16 bytes with (batch, seq, "
                f"head) strides multiples of {per16} elements for the tensor-core kernel's TMA "
                f"loads, got address % 16 = {t.data_ptr() % 16}, strides {t.stride()[:3]}"
            )
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    global launches
    lib = load()
    # the current device for the launch and for the TMA descriptors' encoding
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, S, H, KV, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            scale_of(hd), int(bool(causal)), int(window or 0), float(cap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    launches += 1
    return out

