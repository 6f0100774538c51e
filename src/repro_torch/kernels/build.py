"""Build and load the port's CUDA kernels: one helper for every kernel.

Each kernel's ``csrc/*.cu`` is compiled with ``nvcc`` into a shared library
with a plain C interface under ``build/repro_torch_kernels/`` at first use,
and loaded with `ctypes`. The library's name carries a hash of every file
under the source's ``csrc/`` (the ``.cu`` and the headers it includes) and of
the flags, so an edited source or header is rebuilt and never loaded stale.
Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: Hopper (sm_90a), a plain C interface in a shared library, ptxas' report
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def aligned16(t) -> bool:
    """Whether a kernel may move ``t`` in 16-byte pieces (cp.async): its
    start and the byte strides of its dims longer than 1, all but the last,
    are multiples of 16 bytes (the last dim is contiguous)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st * size % 16 == 0 for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


def refuse_autograd(name: str, *inputs) -> None:
    """Raise if autograd would record a launch of kernel ``name``: grad mode
    is on and a floating input requires grad. The kernels are forward only,
    as the TPU kernels are (the reference differentiates its plain path), and
    the output a launch writes has no ``grad_fn``: a loss built on it would
    train with zero gradient through the kernel, silently."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.is_floating_point() and t.requires_grad
            for t in inputs):
        raise RuntimeError(
            f"{name} kernel: forward only, it has no backward pass; an input requires grad "
            "under grad mode, so take the plain route (use_kernel=False) to differentiate"
        )


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME``/``$CUDA_PATH``, then ``PATH``, then
    ``/usr/local/cuda``."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (pathlib.Path(cuda_home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaLibrary:
    """One ``.cu`` source built into a ctypes-bound library at first use.

    ``bind(lib)`` declares ``argtypes``/``restype`` of the library's entry
    points; it runs once, when the library is loaded.
    """

    def __init__(self, name: str, source: pathlib.Path, flags: tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name, self.source, self.flags, self._bind = name, source, flags, bind
        self._lib = None
        self._lock = threading.Lock()

    def build(self) -> tuple[pathlib.Path, str]:
        """Compile the source if needed; return (library, ptxas log)."""
        h = hashlib.sha1(" ".join(self.flags).encode())
        for f in sorted(p for p in self.source.parent.rglob("*") if p.is_file()):
            h.update(f.relative_to(self.source.parent).as_posix().encode() + b"\0")
            h.update(f.read_bytes())
        tag = h.hexdigest()[:12]
        lib = BUILD_DIR / f"{self.name}-{tag}.so"
        if lib.exists():
            return lib, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, lib)
        return lib, proc.stderr

    def load(self) -> ctypes.CDLL:
        """The bound library, built at first use."""
        with self._lock:
            if self._lib is None:
                path, _ = self.build()
                lib = ctypes.CDLL(str(path))
                self._bind(lib)
                self._lib = lib
            return self._lib
