"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ctypes. The library lives in ``build/kernels/`` at the repository
root, and its name carries a hash of the sources and flags, so that an edited
source is rebuilt and a stale library is never loaded. Nothing here runs when
a module is imported: the CPU tests import every module on a host with no
``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on anything but ``cudaSuccess``. Kernels launch on
PyTorch's current stream, allocate nothing and do not synchronise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
# Filled by library(): build seconds (0.0 when an up-to-date library was
# found), the library path, and nvcc's output (-Xptxas -v: registers, shared
# memory and spills of every kernel).
BUILD_INFO: dict = {}

_VP, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "gps_scan": [_I, _I, _VP, _VP, _I, _I, _VP],
    "gps_nn_min_dist2": [_I, _VP, _I, _VP, _VP, _VP, _I, _I, _VP, _VP],
    "gps_ransac_counts": [_I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _D, _VP, _VP],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libgps_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(p) for p in sorted(CSRC.glob("*.cu"))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gps_error_string.argtypes = [ctypes.c_int]
    lib.gps_error_string.restype = ctypes.c_char_p
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(so), log=log)
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned anything but cudaSuccess."""
    if rc != 0:
        msg = library().gps_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.float64:
        return 1
    raise TypeError(f"kernels take float32 or float64, got {t.dtype}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(*tensors: torch.Tensor, contiguous: bool = True) -> None:
    """Every tensor on the same CUDA device (and contiguous, unless the
    wrapper repacks it); raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected tensors on one CUDA device, got {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
