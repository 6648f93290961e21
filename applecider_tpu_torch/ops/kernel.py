"""Build the port's hand-written CUDA kernels and call them through ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout; the
hash covers the source, every shared header (``csrc/*.cuh``) and the flags,
so an edited source or header builds anew and an unchanged one is loaded as
it is. Every library
exports plain C functions that take device pointers, sizes and the CUDA
stream, launch without synchronising and return ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SOURCES = ("merge_scan", "attention", "ln_gelu", "flash_attention", "int8")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # nvcc's output (ptxas register/smem report) per fresh build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME so that $CUDA_HOME/bin/nvcc exists")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile and load the named kernel libraries, one ``nvcc`` each, all
    started together. Raises with nvcc's output if any build fails."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = []
        for n in todo:
            lib = _library_path(n)
            if lib.exists():
                started.append((n, lib, None, None))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            started.append((n, lib, proc, tmp))
        # wait for every nvcc before raising, so none is left running
        outputs = {n: proc.communicate()[0] for n, _, proc, _ in started if proc is not None}
        failed = [n for n, _, proc, _ in started if proc is not None and proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"--- {n}\n{outputs[n]}" for n in failed))
        for n, lib, proc, tmp in started:
            if proc is not None:
                os.replace(tmp, lib)
                build_log[n] = outputs[n]
            _libs[n] = ctypes.CDLL(str(lib))


class CudaKernel:
    """One exported entry point of a ``csrc`` library, with its launch count.

    ``launches`` goes up by one for each launch that the card accepted; a
    test or ``chip_smoke.py`` sets it to 0 and reads it to see whether a run
    went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            build([self.source])
            fn = getattr(_libs[self.source], self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; tensors pass as pointers."""
        fn = self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
        if err != 0:
            lib = _libs[self.source]
            lib.ac_error_string.restype = ctypes.c_char_p
            lib.ac_error_string.argtypes = [ctypes.c_int]
            msg = lib.ac_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} (cudaError {err})")
        self.launches += 1


def dtype_code(dtype: torch.dtype) -> int:
    """The ``AcDtype`` code of csrc/common.cuh for a floating dtype."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The CUDA device all ``tensors`` share; raises for any other device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"kernel runs on CUDA tensors, got {dev}")
    return dev


def require_cpu_or_cuda(*tensors: torch.Tensor) -> None:
    """Raises unless the tensors lie on the CPU or a CUDA device: a kernel's
    custom op has an implementation for each of the two and no other."""
    for t in tensors:
        if t is not None and t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"kernel runs on CUDA tensors (or CPU tensors, its plain version), "
                             f"got {t.device}")


def require_aligned(*tensors: torch.Tensor, nbytes: int = 16) -> None:
    """Raises unless each tensor's data starts on an ``nbytes`` boundary: the
    bf16 tensor-core kernels load q, k and v in 16-byte chunks."""
    for t in tensors:
        if t.data_ptr() % nbytes:
            raise ValueError(f"kernel takes tensors whose data is {nbytes}-byte aligned; "
                             f"got an offset of {t.data_ptr() % nbytes} bytes (clone the tensor)")
