"""Build, bind and launch the CUDA kernel of Alg. A2's Adam loops.

``csrc/p4_adam.cu`` (its header says what it replaces, what bounds it and
how it is laid out) is built and loaded by `repro_torch.kernels.build` at
first use. Nothing is built when this module is imported.

This module only builds, binds and launches: `pgd_loop` (the loop of
`core.pgd.solve_p4_pgd`) and `power_loop` (that of `core.pgd.power_given_x`)
take contiguous float32 CUDA tensors with one leading row axis, and raise on
anything else or on a failed launch. They launch with the inputs' card
current (`torch.cuda.device`), on that card's current stream. Which inputs
reach them, and how they are laid out, is `ops.py`'s choice. `launches`
counts the kernel's launches (set it to 0 to start a count).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ..build import BASE_FLAGS, CudaLibrary, refuse_autograd

#: kernel launches since the counter was last set to 0; `repro_torch.spans`
#: records its change over each span
launches = 0

SOURCE = pathlib.Path(__file__).resolve().with_name("csrc") / "p4_adam.cu"
NVCC_FLAGS = BASE_FLAGS
#: rows of at most this many devices hold them in a lane's registers
#: (unrolled over 4 or 16); wider rows take the wide kernel, whose state
#: lives in device memory (the moment buffers and a scratch)
LANE_MAX_N = 16
#: the most devices and subcarriers a row may have: the serving ladder's
#: widest bucket, (64, 256); one lane (at most 16 devices) or one warp's
#: lanes (more) a subcarrier, eight a lane at most
MAX_N, MAX_K = 64, 256
_LN2 = 0.6931471805599453


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.p4_adam_run
    fn.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 24
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 7
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int


_LIB = CudaLibrary("p4_adam", SOURCE, NVCC_FLAGS, _bind)
#: compile ``csrc/p4_adam.cu`` if needed; return (library, ptxas log)
build = _LIB.build
#: the bound library, built at first use
load = _LIB.load


def schedule(steps: int, temp_end: float, device) -> torch.Tensor:
    """(steps, 3) float32: each step's softmax temperature and Adam bias
    corrections 1 - 0.9^t and 1 - 0.999^t (t = i + 1), each computed as the
    plain loop computes it from its float32 step counter, on ``device``."""
    i = torch.arange(steps, dtype=torch.float32, device=device)
    t = i + 1
    temp = 1.0 + (temp_end - 1.0) * (i / max(steps - 1, 1))
    return torch.stack([temp, 1 - 0.9**t, 1 - 0.999**t], dim=-1).contiguous()


def _check(name: str, t, shape: tuple, device) -> int:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"p4_adam kernel: {name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"p4_adam kernel: {name} is on {t.device}, the rows on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"p4_adam kernel: {name} is {t.dtype}, not float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"p4_adam kernel: {name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"p4_adam kernel: {name} is not contiguous")
    return t.data_ptr()


def _run(power: bool, rows: dict, logits: dict, x_fixed, *, steps: int, q: int, lr: float,
         penalty_rate: float, penalty_binary: float, temp_end: float, bbar: float,
         noise_sc: float, moments: bool):
    """Check the arguments and launch; returns (P, X or None, logits after
    the steps, their moments or None), each with the inputs' shapes."""
    global launches
    refuse_autograd("p4_adam", *rows.values(), *logits.values(), x_fixed)
    w = logits["w"]
    if not isinstance(w, torch.Tensor) or w.ndim != 3:
        raise ValueError("p4_adam kernel: w must be a (rows, N, K) tensor")
    R, N, K = w.shape
    dev = w.device
    if not 1 <= N <= MAX_N or not 1 <= K <= MAX_K:
        raise ValueError(f"p4_adam kernel: takes 1 <= N <= {MAX_N} devices and 1 <= K <= "
                         f"{MAX_K} subcarriers, got N={N}, K={K}")
    if int(q) != q or q < 1:
        raise ValueError(f"p4_adam kernel: takes a whole exponent q >= 1, got {q}")
    if steps < 0:
        raise ValueError(f"p4_adam kernel: steps must be >= 0, got {steps}")
    shapes = {"g": (R, N, K), "p_max": (R, N), "dev_mask": (R, N), "sc_mask": (R, K),
              "payload": (R, N), "rmin": (R, N), "kappa1": (R,),
              "z": (R, N + 1, K), "w": (R, N, K), "w_tot": (R, N), "x_fixed": (R, N, K)}
    ptr = {n: _check(n, t, shapes[n], dev) for n, t in (*rows.items(), *logits.items())}
    if power:
        ptr["x_fixed"] = _check("x_fixed", x_fixed, shapes["x_fixed"], dev)

    out = {n: torch.empty_like(t) for n, t in logits.items()}
    wide = N > LANE_MAX_N          # the wide kernel keeps the moments in their buffers
    mom = ({f"{m}_{n}": torch.empty_like(t) for n, t in logits.items() for m in "mv"}
           if moments or wide else {})
    work = (torch.empty((R, (N + 1) * K + 3 * N * K), dtype=torch.float32, device=dev)
            if wide else None)
    P = torch.empty((R, N, K), dtype=torch.float32, device=dev)
    X = None if power else torch.empty_like(P)
    if R > 0:
        sched = schedule(steps, temp_end, dev)
        p = lambda t: t.data_ptr() if t is not None else None
        lib = load()
        with torch.cuda.device(dev):
            err = lib.p4_adam_run(
                int(power),
                *(ptr[n] for n in ("g", "p_max", "dev_mask", "sc_mask", "payload", "rmin", "kappa1")),
                ptr.get("x_fixed"), p(sched) if steps else None,
                ptr.get("z"), ptr["w"], ptr["w_tot"],
                p(out.get("z")), p(out["w"]), p(out["w_tot"]),
                *(p(mom.get(f"{m}_{n}")) for n in ("z", "w", "w_tot") for m in "mv"),
                p(P), p(X), p(work),
                R, N, K, int(steps), int(q),
                float(lr), float(penalty_rate), float(penalty_binary), float(temp_end),
                float(bbar), _f32_inverse(noise_sc), _f32_inverse(_LN2),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"p4_adam_run launch failed: CUDA error {err}")
        launches += 1
    names = tuple(logits)
    moments_out = tuple((mom[f"m_{n}"], mom[f"v_{n}"]) for n in names) if moments else None
    return P, X, tuple(out[n] for n in names), moments_out


def _f32_inverse(x: float) -> float:
    """1 / x with x and the quotient in float32, as the plain version divides
    a float32 tensor by a python float on the card."""
    f = torch.tensor(float(x), dtype=torch.float32)
    return float(torch.reciprocal(f))


def pgd_loop(g, p_max, dev_mask, sc_mask, payload, rmin, kappa1, z, w, w_tot, *, steps: int,
             q: int, lr: float, penalty_rate: float, penalty_binary: float, temp_end: float,
             bbar: float, noise_sc: float, moments: bool = False):
    """`steps` Adam steps of `core.pgd.solve_p4_pgd`'s loss from the logits
    z (R, N+1, K), w (R, N, K) and w_tot (R, N), then the decode at
    ``temp_end``: (P, X, (z, w, w_tot), ((m, v) of each) or None).

    g (R, N, K); p_max, dev_mask, payload, rmin (R, N); sc_mask (R, K);
    kappa1 (R,): contiguous float32 tensors on one card. The inputs are
    not written.
    """
    rows = dict(g=g, p_max=p_max, dev_mask=dev_mask, sc_mask=sc_mask, payload=payload,
                rmin=rmin, kappa1=kappa1)
    return _run(False, rows, dict(z=z, w=w, w_tot=w_tot), None, steps=steps, q=q, lr=lr,
                penalty_rate=penalty_rate, penalty_binary=penalty_binary, temp_end=temp_end,
                bbar=bbar, noise_sc=noise_sc, moments=moments)


def power_loop(g, p_max, dev_mask, sc_mask, payload, rmin, kappa1, X, w, w_tot, *, steps: int,
               lr: float, penalty_rate: float, bbar: float, noise_sc: float,
               moments: bool = False):
    """`steps` Adam steps of `core.pgd.power_given_x`'s loss for the fixed X
    (R, N, K) from the logits w (R, N, K) and w_tot (R, N), then the
    decode: (P, (w, w_tot), ((m, v) of each) or None). The other arguments
    as in `pgd_loop`."""
    rows = dict(g=g, p_max=p_max, dev_mask=dev_mask, sc_mask=sc_mask, payload=payload,
                rmin=rmin, kappa1=kappa1)
    P, _, out, mom = _run(True, rows, dict(w=w, w_tot=w_tot), X, steps=steps, q=1, lr=lr,
                          penalty_rate=penalty_rate, penalty_binary=0.0, temp_end=1.0,
                          bbar=bbar, noise_sc=noise_sc, moments=moments)
    return P, out, mom
