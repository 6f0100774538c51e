"""Public WKV6 op, with dispatch.

Counterpart of `repro.kernels.rwkv6_scan.ops`: r/k/v/w (B, H, S, hd), u
(H, hd). From the zero state, ``use_kernel="auto"`` (the reference's
``use_pallas="auto"``) means: the CUDA kernel iff the tensors lie on a CUDA
device, the plain recurrence (`ref.rwkv6_scan`) for CPU tensors;
``use_kernel=True`` on CPU tensors raises; ``use_kernel=False`` asks for the
plain version on any device. The kernel, like the TPU kernel, starts at zero
and writes only y, so a carried state takes the plain recurrence, and asking
for the kernel with one raises. A kernel that fails raises; nothing falls
back. The kernel reads strided views and runs a ragged S itself, so nothing
is padded or transposed here (the reference's op pads time with w = 1).
"""
from __future__ import annotations

from repro_torch.device import wants_kernel

from . import kernel, ref


def rwkv6_scan(r, k, v, w, u, state=None, *, out_dtype=None, use_kernel: str | bool = "auto"):
    """The WKV6 recurrence: (y (B, H, S, hd) in ``out_dtype``, r's type if
    None, final state).

    ``state``: (B, H, hd, hd) carried from earlier steps, or None for the
    zero state. From the zero state the final state is None on every route
    (the kernel does not write it; the forward path discards it); from a
    carried state it is the plain recurrence's, float32. ``use_kernel=True``
    with a carried state raises, whatever its values (telling a zero state
    apart would stop the host for the card).
    """
    if state is not None:
        if use_kernel != "auto" and use_kernel:
            raise ValueError(
                "rwkv6_scan: the WKV kernel starts from the zero state; a carried "
                "state takes the plain recurrence (use_kernel='auto' or False)"
            )
        return ref.rwkv6_scan(r, k, v, w, u, state, out_dtype)
    if wants_kernel(use_kernel, r):
        return kernel.rwkv6_scan(r, k, v, w, u, out_dtype), None
    return ref.rwkv6_scan(r, k, v, w, u, out_dtype=out_dtype)[0], None
