"""Public selective-scan op, with dispatch.

Counterpart of `repro.kernels.mamba_scan.ops`: x, dt (B, S, di), Bm, Cm
(B, S, N), A (di, N), D (di,). From the zero state, ``use_kernel="auto"``
(the reference's ``use_pallas="auto"``) means: the CUDA kernel iff the
tensors lie on a CUDA device, the plain recurrence (`ref.mamba_scan`) for
CPU tensors; ``use_kernel=True`` on CPU tensors raises; ``use_kernel=False``
asks for the plain version on any device. The kernel, like the TPU kernel,
starts at zero and writes only y, so a carried state takes the plain
recurrence, and asking for the kernel with one raises. A kernel that fails
raises; nothing falls back. The kernel reads strided views and runs a
ragged S itself, so nothing is padded or transposed here (the reference's
op pads time with dt = 0).
"""
from __future__ import annotations

from repro_torch.device import wants_kernel

from . import kernel, ref


def mamba_scan(x, dt, Bm, Cm, A, D, h0=None, *, use_kernel: str | bool = "auto"):
    """The selective scan: (y (B, S, di) in x's type, final state).

    ``h0``: (B, di, N) carried from earlier steps, or None for the zero
    state. From the zero state the final state is None on every route (the
    kernel does not write it; the forward path discards it); from a carried
    state it is the plain recurrence's, float32. ``use_kernel=True`` with a
    carried state raises, whatever its values (telling a zero state apart
    would stop the host for the card).
    """
    if h0 is not None:
        if use_kernel != "auto" and use_kernel:
            raise ValueError(
                "mamba_scan: the selective-scan kernel starts from the zero state; a "
                "carried state takes the plain recurrence (use_kernel='auto' or False)"
            )
        return ref.mamba_scan(x, dt, Bm, Cm, A, D, h0)
    if wants_kernel(use_kernel, x):
        return kernel.mamba_scan(x, dt, Bm, Cm, A, D), None
    return ref.mamba_scan(x, dt, Bm, Cm, A, D)[0], None
