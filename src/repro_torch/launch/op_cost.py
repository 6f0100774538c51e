"""Per-device cost of a step, counted op by op on the local shards.

Counterpart of `repro.launch.hlo_cost`, which parses the compiled
per-device HLO: here `OpCost`, a dispatch mode, sees every op the step
dispatches on this rank's local tensors (an op on DTensors is let through
to DTensor, whose own ops on the local tensors are then seen), so every
count is per device:

  * dot FLOPs: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (2 x the product of
    the result's size and the contraction size) and ``convolution``; the
    flash kernel's op at 4 x hd per unmasked (query, key) pair and head,
    the count of ``chip_smoke.py``'s ``flash_bound``, where `stand_ins`
    replaces the kernel (a launch through its library is no op the mode
    sees);
  * the recurrences' float32 operations (the WKV6 and selective-scan
    kernels' counts in ``chip_smoke.py``'s bounds), apart;
  * collective link bytes: the result bytes of each functional collective,
    an all-reduce weighted 2x (the ring's reduce and broadcast phases), as
    the reference weights them;
  * HBM bytes (approximate): the reference's structural estimate, each
    op's operand and result bytes (views, metadata and wait ops excluded).
    Eager ops fuse nothing, so this is an upper-ish bound.

A TorchDispatchMode around DTensor ops would see the global op (the
trap of `torch.utils.flop_counter.FlopCounterMode` on a DTensor); the
model's mesh path computes on local tensors, and `OpCost` defers DTensor
ops to DTensor, so what it counts is the device's own.

`stand_ins` is for a trace with no data (`launch.dryrun`, fake tensors):
it replaces the three kernels' launches, and where no gradient is taken
their plain versions too (a trace on the CPU, where the kernels cannot
run, counts the kernels' work), by functions that count that work and
return outputs of the right shape; the plain recurrences of WKV6 and the
selective scan under autograd (a Python loop over time), and the chunked
plain attention, by functions with a gradient that count their einsums'
dot FLOPs as the plain versions dispatch them (`_Recurrence`,
`_Attention`). The launch counters are not touched.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode


COLLECTIVES = {"all_reduce": 2.0, "all_reduce_": 2.0, "all_gather_into_tensor": 1.0,
               "reduce_scatter_tensor": 1.0, "all_to_all_single": 1.0}
_SKIP_BYTES = {"wait_tensor", "empty", "empty_strided", "empty_like", "detach", "alias",
               "lift_fresh", "_local_scalar_dense", "device", "sym_size", "sym_stride", "dim"}

#: the active counters (`OpCost` contexts), which the stand-ins report to
_ACTIVE: list = []


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    return 0


def _dot_flops(name, args, out) -> float:
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    if name == "convolution":
        w = args[1]
        return 2.0 * out.numel() * math.prod(w.shape[1:])
    return 0.0


class OpCost(TorchDispatchMode):
    """Counts (see the module's docstring): ``flops`` (dot FLOPs and the
    flash kernel's), ``scan_ops``, ``collective_bytes`` with
    ``collective_counts`` by kind, ``hbm_bytes``, and ``kernel_calls`` by
    kernel."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.scan_ops = 0.0
        self.collective_bytes = 0.0
        self.collective_counts: dict = defaultdict(int)
        self.hbm_bytes = 0.0
        self.kernel_calls: dict = defaultdict(int)

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented               # DTensor's own local ops are counted
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in COLLECTIVES:
            self.collective_bytes += COLLECTIVES[name] * _bytes(out)
            self.collective_counts[name.rstrip("_")] += 1
            return out
        self.flops += _dot_flops(name, args, out)
        if not func.is_view and name not in _SKIP_BYTES and func.namespace == "aten":
            self.hbm_bytes += _bytes(list(args)) + _bytes(out)
        return out

    def note_kernel(self, name: str, flops: float = 0.0, scan_ops: float = 0.0, nbytes: float = 0.0):
        self.kernel_calls[name] += 1
        self.flops += flops
        self.scan_ops += scan_ops
        self.hbm_bytes += nbytes

    def as_dict(self) -> dict:
        return {"flops": self.flops, "scan_ops": self.scan_ops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "collective_counts": dict(self.collective_counts),
                "kernel_calls": dict(self.kernel_calls)}


def _note(name, **kw):
    for c in _ACTIVE:
        c.note_kernel(name, **kw)


# ---------------------------------------------------------------------------
# the kernels' work, and their stand-ins for a trace with no data
# ---------------------------------------------------------------------------

def attention_pairs(S: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one (batch, head): keys at positions
    past the query's masked if ``causal``, at qpos - kpos >= ``window``."""
    w = window if window is not None and window < S else None
    if causal:
        return S * (S + 1) // 2 if w is None else w * (w + 1) // 2 + (S - w) * w
    return S * S if w is None else S * S - (S - w) * (S - w + 1) // 2


def flash_work(q, k, v, causal, window) -> dict:
    B, S, H, hd = q.shape
    return dict(flops=4.0 * hd * B * H * attention_pairs(S, causal, window),
                nbytes=2 * _bytes(q) + _bytes(k) + _bytes(v))


def wkv_work(r, out_dtype) -> dict:
    B, H, S, hd = r.shape
    item = torch.empty((), dtype=out_dtype).element_size()
    return dict(scan_ops=float(B * H * S * (5 * hd * hd + 5 * hd)),
                nbytes=4 * _bytes(r) + B * H * S * hd * item)


def scan_work(x, Bm) -> dict:
    B, S, di = x.shape
    return dict(scan_ops=float(B * S * di * (6 * Bm.shape[-1] + 3)),
                nbytes=3 * _bytes(x) + 2 * _bytes(Bm))


class _Recurrence(torch.autograd.Function):
    """A plain recurrence's stand-in: outputs of its shapes, its per-step
    einsums' dot FLOPs forward (``flops``) and twice that backward."""

    @staticmethod
    def forward(ctx, name, flops, shapes, *inputs):
        ctx.name, ctx.flops = name, flops
        ctx.metas = [(t.shape, t.dtype, t.device) if isinstance(t, torch.Tensor) else None for t in inputs]
        _note(name, flops=flops)
        return tuple(torch.empty(s, dtype=dt, device=dev) for s, dt, dev in shapes)

    @staticmethod
    def backward(ctx, *grads):
        _note(ctx.name + "_backward", flops=2 * ctx.flops)
        return (None, None, None) + tuple(
            None if m is None else torch.empty(m[0], dtype=m[1], device=m[2]) for m in ctx.metas)


class _Attention(torch.autograd.Function):
    """The chunked plain attention's stand-in under autograd: its two
    einsums over every (query chunk, key chunk) pair, padding included
    (``flops``), forward; backward, each query chunk's recomputation (the
    plain version checkpoints it) and the two einsums' gradients, 3x."""

    @staticmethod
    def forward(ctx, flops, out, q, k, v):
        ctx.flops, ctx.metas = flops, [(t.shape, t.dtype, t.device) for t in (q, k, v)]
        _note("flash_attention_plain", flops=flops)
        return torch.empty(out[0], dtype=out[1], device=out[2])

    @staticmethod
    def backward(ctx, g):
        _note("flash_attention_plain_backward", flops=3 * ctx.flops)
        return (None, None) + tuple(torch.empty(s, dtype=dt, device=dev) for s, dt, dev in ctx.metas)


def _fake_flash(q, k, v, *, causal=True, window=None, cap=None):
    _note("flash_attention", **flash_work(q, k, v, causal, window))
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _fake_wkv_kernel(r, k, v, w, u, out_dtype=None):
    out_dtype = r.dtype if out_dtype is None else out_dtype
    _note("rwkv6_scan", **wkv_work(r, out_dtype))
    return torch.empty(r.shape, dtype=out_dtype, device=r.device)


def _fake_scan_kernel(x, dt, Bm, Cm, A, D):
    _note("mamba_scan", **scan_work(x, Bm))
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def _training(*xs) -> bool:
    return torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _fake_wkv_ref(r, k, v, w, u, state=None, out_dtype=None):
    out_dtype = r.dtype if out_dtype is None else out_dtype
    B, H, S, hd = r.shape
    if not _training(r, k, v, w, u):
        return _fake_wkv_kernel(r, k, v, w, u, out_dtype), torch.empty(
            (B, H, hd, hd), dtype=torch.float32, device=r.device)
    shapes = [((B, H, S, hd), out_dtype, r.device), ((B, H, hd, hd), torch.float32, r.device)]
    return _Recurrence.apply("rwkv6_plain", 2.0 * B * H * S * hd * hd, shapes, r, k, v, w, u, state)


def _fake_scan_ref(x, dt, Bm, Cm, A, D, h0=None):
    B, S, di = x.shape
    N = Bm.shape[-1]
    if not _training(x, dt, Bm, Cm, A, D):
        return _fake_scan_kernel(x, dt, Bm, Cm, A, D), torch.empty(
            (B, di, N), dtype=torch.float32, device=x.device)
    shapes = [((B, S, di), x.dtype, x.device), ((B, di, N), torch.float32, x.device)]
    return _Recurrence.apply("mamba_plain", 2.0 * B * S * di * N, shapes, x, dt, Bm, Cm, A, D, h0)


@contextlib.contextmanager
def stand_ins():
    """The kernels, and their plain versions where no gradient is taken
    (a prefill traced where the kernels cannot run: the kernel's work is
    counted), replaced by stand-ins; the plain recurrences under autograd
    by `_Recurrence` (module docstring). For a trace on fake tensors."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.mamba_scan import kernel as sk, ref as sr
    from repro_torch.kernels.rwkv6_scan import kernel as wk, ref as wr
    from repro_torch.models import attention as attn

    plain = attn.flash_attention

    def plain_or_kernel(q, k, v, *, q_positions, kv_positions, causal=True, window=None, cap=None,
                        q_chunk=512, kv_chunk=1024):
        shape = q.shape[:-1] + v.shape[-1:]
        if _training(q, k, v):
            B, S, H, hd = q.shape
            qp, kp = -(-S // q_chunk) * q_chunk, -(-k.shape[1] // kv_chunk) * kv_chunk
            flops = 2.0 * B * H * qp * kp * (hd + v.shape[-1])
            return _Attention.apply(flops, (shape, v.dtype, q.device), q, k, v)
        _note("flash_attention", **flash_work(q, k, v, causal, window))
        return torch.empty(shape, dtype=v.dtype, device=q.device)

    swaps = [(fa, "flash_attention", _fake_flash), (wk, "rwkv6_scan", _fake_wkv_kernel),
             (sk, "mamba_scan", _fake_scan_kernel), (wr, "rwkv6_scan", _fake_wkv_ref),
             (sr, "mamba_scan", _fake_scan_ref), (attn, "flash_attention", plain_or_kernel)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
